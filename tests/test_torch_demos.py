"""The port's demos (libplacebo_tpu_torch/demos/) against the JAX
package's (demos/), run in-process with the same argv on the CPU
(`--cpu`), at 96x64 sources made from seeds.

Tolerances: colors' y4m bytes identical (clear_target and the writer
are exact); plplay's per-frame 8-bit codes, video_filtering's and
image_viewer's 8-bit outputs more than one LSB apart on at most 5e-4 of
the values (ROADMAP §3 F1: ulp differences upstream turn into 1-LSB
flips at the 8-bit rounding); the settings panel's state (Options.save()
and the visible rows) equal.  multichip_bench on 2 and 4 gloo ranks
holds its sharded outputs to the single-device render within one LSB on
<= 1e-4 of the values (the halo gate of tests/torch_parallel_ranks.py).
"""
import os
import sys

import numpy as np
import pytest

import chip_smoke
from libplacebo_tpu.utils.y4m import read_png, write_png
from libplacebo_tpu_torch.demos import colors as t_colors
from libplacebo_tpu_torch.demos import image_viewer as t_image_viewer
from libplacebo_tpu_torch.demos import multichip_bench as t_multichip
from libplacebo_tpu_torch.demos import plplay as t_plplay
from libplacebo_tpu_torch.demos import settings_ui as t_settings
from libplacebo_tpu_torch.demos import video_filtering as t_video_filtering

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "demos"))

import colors as j_colors  # noqa: E402
import image_viewer as j_image_viewer  # noqa: E402
import plplay as j_plplay  # noqa: E402
import settings_ui as j_settings  # noqa: E402
import video_filtering as j_video_filtering  # noqa: E402


def _run_jax(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__name__] + argv)
    return mod.main()


def _codes_gate(a: np.ndarray, b: np.ndarray, what: str):
    """8-bit codes: more than one LSB apart on at most 5e-4 of them."""
    assert a.shape == b.shape, (what, a.shape, b.shape)
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert (d > 1).mean() <= 5e-4, (what, d.max(), (d > 1).mean())
    return d


def test_colors_y4m_bytes_identical(tmp_path, monkeypatch, capsys):
    argv = ["--frames", "4", "--size", "96x64", "--write-y4m"]
    _run_jax(j_colors, argv + [str(tmp_path / "j.y4m")], monkeypatch)
    t_colors.main(argv + [str(tmp_path / "t.y4m"), "--cpu"])
    data = (tmp_path / "t.y4m").read_bytes()
    assert data == (tmp_path / "j.y4m").read_bytes()
    assert data.startswith(b"YUV4MPEG2")
    assert data.count(b"FRAME") == 4
    assert "4 frames" in capsys.readouterr().out


PLPLAY_CASES = {
    # 1:1 into the 2x target (fit never upscales): the queue, the mix
    # and K1's tail
    "hdr": ["--hdr"],
    # a real 2x EWA upscale with deband, the video padded to the target
    "ewa_deband": ["--hdr", "--options", "upscaler=ewa_lanczos,deband=yes",
                   "--zoom", "pad"],
    "rotate90": ["--hdr", "--rotate", "90"],
}


@pytest.mark.parametrize("case", list(PLPLAY_CASES))
def test_plplay_matches_the_jax_demo(case, tmp_path, monkeypatch, capsys):
    argv = ["--size", "96x64", "--out", "192x128", "--frames", "4",
            "--fps", "24", "--vsync", "60"] + PLPLAY_CASES[case]
    _run_jax(j_plplay, argv + ["--cpu", "--write-y4m",
                               str(tmp_path / "j.y4m")], monkeypatch)
    jax_out = capsys.readouterr().out
    stats = t_plplay.main(argv + ["--cpu", "--write-y4m",
                                  str(tmp_path / "t.y4m")])
    out = capsys.readouterr().out
    # the JAX demo's summary lines, then the kernels' line
    assert out.splitlines()[1:3] == jax_out.splitlines()[1:3]
    assert "played 10 vsyncs (4 source frames)" in out
    assert stats["rendered"] == 10 and stats["launches"] == \
        {"k1": 0, "k2": 0, "k3": 0}
    jh, jf = chip_smoke._y4m_planes(tmp_path / "j.y4m")
    th, tf = chip_smoke._y4m_planes(tmp_path / "t.y4m")
    assert th == jh and len(tf) == len(jf) == 10
    for i, (a, b) in enumerate(zip(tf, jf)):
        _codes_gate(a, b, f"{case} vsync {i}")
    # the frames carry the picture, not only the border
    assert max(f.std() for f in tf) > 10


@pytest.fixture
def still(tmp_path):
    """The JAX demo test's picture, OSD and LUT."""
    rng = np.random.default_rng(0)
    img = np.clip(np.linspace(0, 239, 64 * 96 * 3).reshape(64, 96, 3)
                  + rng.uniform(0, 16, (64, 96, 3)), 0, 255).astype(np.uint8)
    write_png(str(tmp_path / "in.png"), img)
    osd = np.zeros((12, 24, 4), np.uint8)
    osd[..., 0] = 255
    osd[..., 3] = 200
    write_png(str(tmp_path / "osd.png"), osd)
    (tmp_path / "warm.cube").write_text(
        "LUT_3D_SIZE 2\n0 0 0\n1 0 0\n0 1 0\n1 1 0\n"
        "0 0 1\n1 0 1\n0 1 1\n1 1 1\n")
    (tmp_path / "p3.icc").write_bytes(chip_smoke.display_p3_profile())
    return tmp_path


@pytest.mark.parametrize("icc", [False, True], ids=["lut_osd", "icc"])
def test_image_viewer_matches_the_jax_demo(icc, still, monkeypatch, capsys):
    argv = [str(still / "in.png"), "--osd", str(still / "osd.png"),
            "--lut", str(still / "warm.cube"), "--out", "192x128"]
    if icc:
        argv += ["--icc", str(still / "p3.icc")]
    _run_jax(j_image_viewer, argv + ["--cpu", "--output",
                                     str(still / "j.png")], monkeypatch)
    t_image_viewer.main(argv + ["--cpu", "--output", str(still / "t.png")])
    assert "rendered 96x64 -> 192x128" in capsys.readouterr().out
    res = read_png(str(still / "t.png"))
    _codes_gate(np.rint(res * 255), np.rint(read_png(str(still / "j.png"))
                                            * 255), "image_viewer")
    assert res.shape[-2:] == (128, 192)
    # the JAX test's own: the OSD tint near the top-left corner, and the
    # far corner carrying image content (96/64 into 192/128: full fill)
    assert res[0, 22, 28] > res[1, 22, 28] + 0.2
    assert res[:3, -2, -2].mean() > 0.1


@pytest.mark.parametrize("kind", ["png", "y4m"])
def test_video_filtering_matches_the_jax_demo(kind, still, monkeypatch,
                                              capsys):
    src = still / "in.png"
    if kind == "y4m":
        from libplacebo_tpu_torch.utils.y4m import Y4MWriter
        rng = np.random.default_rng(3)
        src = still / "in.y4m"
        with Y4MWriter(str(src), 96, 64) as wr:
            for _ in range(2):
                wr.write(((rng.random((64, 96)) * 219 + 16).astype(np.uint8),
                          (rng.random((32, 48)) * 224 + 16).astype(np.uint8),
                          (rng.random((32, 48)) * 224 + 16).astype(np.uint8)))
    argv = ["--input", str(src), "--out", "192x128"]
    _run_jax(j_video_filtering, argv + ["--cpu", "--output",
                                        str(still / f"j.{kind}")],
             monkeypatch)
    t_video_filtering.main(argv + ["--cpu", "--output",
                                   str(still / f"t.{kind}")])
    out = capsys.readouterr().out
    assert out.count("-> 192x128 (deband + EWA upscale + 3DLUT + dither)") \
        == 2
    if kind == "png":
        _codes_gate(np.rint(read_png(str(still / "t.png")) * 255),
                    np.rint(read_png(str(still / "j.png")) * 255),
                    "video_filtering png")
    else:
        jh, jf = chip_smoke._y4m_planes(still / "j.y4m")
        th, tf = chip_smoke._y4m_planes(still / "t.y4m")
        assert th == jh and len(tf) == len(jf) == 2
        for a, b in zip(tf, jf):
            _codes_gate(a, b, "video_filtering y4m")


# -- the live settings panel: tests/test_demos.py's cases on the port ----

def _panel(mod=t_settings):
    return mod.SettingsPanel(mod.Options())


def _type_keys(panel, keys):
    for k in keys:
        assert panel.handle_key(k)


def test_settings_panel_covers_every_option():
    from libplacebo_tpu_torch.core.options import OPTION_TABLE
    panel = _panel()
    real = [o for o in OPTION_TABLE() if o.type != "preset"]
    rows = panel.visible()
    assert len(rows) == len(real)
    assert all(isinstance(v, str) for _, v, _ in rows)
    assert all(d for _, _, d in rows)        # fresh Options == defaults


def test_settings_panel_cycle_enum_and_bool():
    panel = _panel()
    _type_keys(panel, list("/upscaler") + ["\n"])
    rows = panel.visible()
    assert rows and rows[0][0] == "upscaler"
    before = panel.options.get("upscaler")
    _type_keys(panel, [" "])
    assert panel.options.get("upscaler") != before
    _type_keys(panel, ["LEFT"])
    assert panel.options.get("upscaler") == before

    panel2 = _panel()
    _type_keys(panel2, list("/deband") + ["\n"])
    assert panel2.visible()[0][0] == "deband"
    assert panel2.options.get("deband") is False
    _type_keys(panel2, [" "])
    assert panel2.options.get("deband") is True
    assert panel2.options.params.deband is not None


def test_settings_panel_edit_validation_and_reset():
    panel = _panel()
    _type_keys(panel, list("/antiringing_strength") + ["\n"])
    assert panel.visible()[0][0] == "antiringing_strength"
    _type_keys(panel, ["\n"])
    assert panel.editing
    panel.edit_buf = ""
    _type_keys(panel, list("0.7") + ["\n"])
    assert panel.options.get("antiringing_strength") == pytest.approx(0.7)
    # invalid input surfaces in the status line, never raises
    _type_keys(panel, ["\n"])
    panel.edit_buf = ""
    _type_keys(panel, list("not_a_number") + ["\n"])
    assert panel.status.startswith("error:")
    assert panel.options.get("antiringing_strength") == pytest.approx(0.7)
    # the range clamp comes from Options.set
    panel.start_edit()
    panel.edit_buf = "7.0"
    panel.commit_edit()
    assert panel.options.get("antiringing_strength") == pytest.approx(1.0)
    assert "antiringing_strength" in panel.options.save()
    _type_keys(panel, ["d"])
    assert panel.options.save() == ""


def test_settings_panel_nudge_float_from_zero():
    panel = _panel()
    _type_keys(panel, list("/antiringing_strength") + ["\n"])
    assert panel.options.get("antiringing_strength") == 0.0
    _type_keys(panel, ["+"])
    v = panel.options.get("antiringing_strength")
    assert 0.0 < v <= 1.0, v
    _type_keys(panel, ["-"])
    assert panel.options.get("antiringing_strength") == pytest.approx(0.0)
    panel2 = _panel()
    _type_keys(panel2, list("/dither_lut_size") + ["\n"])
    assert panel2.visible()[0][0] == "dither_lut_size"
    before = panel2.options.get("dither_lut_size")
    _type_keys(panel2, ["+"])
    after = panel2.options.get("dither_lut_size")
    assert isinstance(after, int) and after == before + 1


def test_settings_panel_preset_and_save_string():
    from libplacebo_tpu_torch.core.options import Options
    panel = _panel()
    _type_keys(panel, ["p"])                        # default -> fast
    assert panel.preset == "fast"
    ref = Options()
    ref.parse("preset=fast")
    assert panel.options.save() == ref.save()
    _type_keys(panel, ["s"])
    assert panel.status != ""
    assert panel.handle_key("q") is False


KEY_SCRIPTS = {
    "cycle_and_nudge": list("/upscaler") + ["\n", " ", " ", "RIGHT"]
    + list("/deband") + ["\n", " ", "DOWN", "+", "+"]
    + list("/tone_mapping") + ["\n", "LEFT"],
    "edit_and_reset": list("/antiringing") + ["\n", "\n"]
    + ["\x7f"] * 4 + list("0.35") + ["\n", "DOWN", " ", "UP", "d"]
    + list("/gamut") + ["\n", " ", " "],
    "presets_and_paging": ["p", "PGDN", " ", "PGDN", "+", "p", "p",
                           "PGUP", "-", "s"],
}


@pytest.mark.parametrize("script", list(KEY_SCRIPTS))
def test_settings_panel_script_matches_the_jax_panel(script):
    """The same keys on both panels leave the same options and rows."""
    panels = [_panel(t_settings), _panel(j_settings)]
    for p in panels:
        for k in KEY_SCRIPTS[script]:
            assert p.handle_key(k)
    port, jax_ = panels
    assert port.options.save() == jax_.options.save()
    assert port.visible() == jax_.visible()
    assert (port.cursor, port.filter, port.preset) == \
        (jax_.cursor, jax_.filter, jax_.preset)


@pytest.mark.parametrize("ranks", [2, 4])
def test_multichip_bench_on_gloo_ranks(ranks, capsys):
    rows = t_multichip.main(["--ranks", str(ranks), "--size", "96x64",
                             "--iters", "1"])
    assert [(r["data"], r["spatial"]) for r in rows] == \
        [(1, ranks), (ranks, 1)]
    for r in rows:
        # the halo gate ran inside (it raises); its figures
        assert r["route"] == "halo"
        assert r["max_diff"] <= t_multichip.LSB + 1e-6
        assert r["frac_differing"] <= 1e-4
        assert r["ms_per_batch"] > 0
    out = capsys.readouterr().out
    assert f"devices: {ranks} x CPU (gloo)" in out
    assert out.count("full pipeline") == 2

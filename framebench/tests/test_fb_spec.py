"""The harness is driven by data: a configuration, a traffic mix and a
per-layer metric dropped into a copy of framebench/ with their entries
in BENCHMARK.json are found by name, with no edit to a file that was
there."""
import json
import os
import shutil

import pytest

from framebench.harness import spec


def _add(root):
    fb = os.path.join(root, "framebench")
    before = {}
    for d, _, files in os.walk(fb):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                before[p] = fh.read()
    with open(os.path.join(fb, "configs", "mpv_ewa_hdr10_to_sdr4k.json")) as f:
        cfg = json.load(f)
    cfg.update(name="mpv_ewa_hdr10_to_1440p")
    cfg["target"].update(w=2560, h=1440)
    with open(os.path.join(fb, "configs", "mpv_ewa_hdr10_to_1440p.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(fb, "traffic", "hdr10_1080p.json")) as f:
        mix = json.load(f)
    mix.update(ring=4)
    with open(os.path.join(fb, "traffic", "hdr10_1080p_ring4.json"),
              "w") as f:
        json.dump(mix, f)
    with open(os.path.join(fb, "metrics", "frames_traced.py"), "w") as f:
        f.write('"""Frames in the traced window."""\n\n\n'
                'def read(rec):\n    return rec["frames"]\n')
    with open(os.path.join(fb, "limits", "play_1440p_ring4.json"), "w") as f:
        json.dump({"max_code_diff": 3}, f)
    p = os.path.join(root, "BENCHMARK.json")
    with open(p) as f:
        bench = json.load(f)
    bench["configs"].append({
        "name": "mpv_ewa_hdr10_to_1440p", "source": "https://mpv.io/",
        "file": "framebench/configs/mpv_ewa_hdr10_to_1440p.json",
        "reduced": [], "why": "a 1440p display"})
    bench["workloads"].append({
        "name": "play_1440p_ring4", "config": "mpv_ewa_hdr10_to_1440p",
        "traffic": "hdr10_1080p_ring4", "chips": 1, "why": "a new cell"})
    bench["per_layer"].append({
        "name": "frames_traced", "unit": "frames", "better": "higher",
        "source": "device_trace", "layer": "the device",
        "moves": "frames_per_s"})
    with open(p, "w") as f:
        json.dump(bench, f)
    return before


def test_new_files_are_found_by_name(tmp_path, checkout):
    root = str(tmp_path / "copy")
    shutil.copytree(checkout, root, symlinks=True)
    before = _add(root)
    cell = spec.resolve("play_1440p_ring4", root)
    assert cell.config["target"]["w"] == 2560
    assert cell.traffic["ring"] == 4
    assert cell.limits == {"max_code_diff": 3}
    assert cell.readers["frames_traced"]({"frames": 7}) == 7
    assert "frames_traced" in {m["name"] for m in cell.per_layer}
    # a metric without a workloads key goes to every cell reporting the
    # end-to-end metric it moves, the cells that were there too
    old = spec.resolve("transcode_2160p_hdr10", root)
    assert "frames_traced" in old.readers
    for p, data in before.items():
        with open(p, "rb") as fh:
            assert fh.read() == data, p


def test_unknown_names_are_refused(checkout):
    with pytest.raises(spec.SpecError):
        spec.resolve("no_such_cell", checkout)


def test_a_split_metric_shares_its_quantitys_reader(checkout):
    bench_dir = os.path.join(checkout, "framebench")
    a = spec.load_reader(bench_dir, "render_host_ms.play")
    b = spec.load_reader(bench_dir, "render_host_ms.anything_else")
    assert a({"render_host_s": [0.002, 0.004]}) == pytest.approx(3.0)
    assert b({"render_host_s": [0.002]}) == pytest.approx(2.0)
    with pytest.raises(spec.SpecError):
        spec.load_reader(bench_dir, "no_such_metric.play")


def test_a_stage_the_reference_lacks_is_refused(tmp_path, checkout):
    root = str(tmp_path / "copy")
    shutil.copytree(checkout, root, symlinks=True)
    p = os.path.join(root, "framebench", "configs",
                     "mpv_ewa_hdr10_to_sdr4k.json")
    with open(p) as f:
        cfg = json.load(f)
    cfg["render_params"]["deband"] = True
    with open(p, "w") as f:
        json.dump(cfg, f)
    with pytest.raises(spec.SpecError, match="deband"):
        spec.resolve("play_1080p_hdr10", root)


def test_every_cell_resolves():
    root = spec.ROOT
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        cell = spec.resolve(w["name"], root)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer and cell.limits

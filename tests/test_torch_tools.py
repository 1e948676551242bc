"""The port's tools (libplacebo_tpu_torch/tools/) on the CPU: the
per-pass micro-benchmark and its differ, the options document, the API
parity check, the playback and stage benchmarks, and the multi-device
tools on gloo ranks — each against the JAX package's tool or artifact
where one exists.
"""
import json
import os

import pytest

from libplacebo_tpu_torch.tools import api_parity
from libplacebo_tpu_torch.tools import bench_micro
from libplacebo_tpu_torch.tools import bench_micro_diff
from libplacebo_tpu_torch.tools import bench_playback
from libplacebo_tpu_torch.tools import gen_options_doc
from libplacebo_tpu_torch.tools import multichip_perf
from libplacebo_tpu_torch.tools import multihost_smoke
from libplacebo_tpu_torch.tools import option_sweep_parity
from libplacebo_tpu_torch.tools import profile_stages

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# every pass of the JAX package's tools/bench_micro.py
JAX_PASSES = (
    "tex_upload ptr", "tex_upload ptr async", "tex_upload u8 device-norm",
    "tex_upload p010 device-norm", "tex_download ptr", "bilinear",
    "bicubic", "hermite", "gaussian", "lanczos_up (separable 2x)",
    "lanczos_up_antiring", "lanczos_down (separable 2x)", "oversample",
    "polar (ewa_lanczos)", "polar antiring", "deband", "deband_heavy",
    "weave", "bob", "yadif", "bwdif", "dither_blue", "dither_white",
    "dither_ordered_fixed", "error_diffusion (FS)", "error_diffusion (JJN)",
    "hdr_peakdetect", "hdr_peakdetect_hq", "hdr_lut (spline tone)",
    "hdr_clip", "av1_grain (luma)", "av1_grain (3 planes)",
    "av1_grain_nolap (3 planes)", "h274_grain", "h274_grain (3 planes)",
    "reshape_poly", "reshape_mmr")


def test_jax_pass_list_is_the_jax_tools():
    src = open(os.path.join(REPO, "tools", "bench_micro.py")).read()
    for name in JAX_PASSES:
        assert f'"{name}"' in src, name


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    out = tmp_path_factory.mktemp("bm") / "bm.json"
    rc = bench_micro.main(["--cpu", "--size", "128x96", "--n", "1",
                           "--json", str(out)])
    return rc, json.loads(out.read_text())


def test_bench_micro_times_every_pass(micro):
    rc, data = micro
    assert rc == 0 and data["failed"] == {}
    assert data["size"] == [128, 96] and data["card"] == "CPU"
    for name in JAX_PASSES + ("k1 color_map_tail (flagship)",):
        p = data["passes"].get(name)
        assert p is not None and p["ms"] > 0, name
        assert p["bytes"] > 0 and p["byte_floor_ms"] > 0, name
        # the profiler: card only
        assert p["launches"] is None and p["device_ms"] is None, name
    # the hand-written kernels' bounds beside their passes
    assert set(data["passes"]["k1 color_map_tail (flagship)"]
               ["kernel_bounds"]) == {"k1"}
    for ed in ("error_diffusion (FS)", "error_diffusion (JJN)"):
        assert set(data["passes"][ed]["kernel_bounds"]) == \
            {"k3_forward", "k2", "k3_inverse"}


def test_bench_micro_bounds_from_the_kernels_arguments(micro):
    """K2's and K3's bounds come from the arguments the pass gave them:
    a 128x96 frame of 3 channels, int16 codes, Floyd-Steinberg's 4 taps
    (shift 2: the sheared frame is 128 + 95 * 2 columns wide)."""
    _, data = micro
    b = data["passes"]["error_diffusion (FS)"]["kernel_bounds"]
    n_px = 3 * 96 * 128
    assert b["k2"]["by"] == "bytes"
    assert b["k2"]["ms"] == pytest.approx(n_px * (4 + 2) / 3.35e9)
    assert b["k3_forward"]["ms"] == pytest.approx(
        (n_px + (128 + 95 * 2) * 3 * 96) * 4 / 3.35e9)
    # the inverse reads the int16 codes and writes them scaled, float32
    assert b["k3_inverse"]["ms"] == pytest.approx(n_px * (2 + 4) / 3.35e9)


def test_profile_violations():
    passes = {
        "fits": {"ms": 1.0, "launches": 3, "device_ms": 0.9},
        "weave": {"ms": 0.001, "launches": 0, "device_ms": 0.0},
        "nothing": {"ms": 1.0, "launches": 0, "device_ms": 0.0},
        "over": {"ms": 1.0, "launches": 1, "device_ms": 1.3},
        # the tracer's cost an operation
        "traced": {"ms": 2.4, "launches": 84, "device_ms": 3.5},
        # a pageable copy's traced span is not held to its ms
        "tex_download ptr": {"ms": 1.9, "launches": 1, "device_ms": 9.5},
        "cpu": {"ms": 1.0, "launches": None, "device_ms": None}}
    assert [n for n, _ in bench_micro.profile_violations(passes)] == \
        ["nothing", "over", "cpu"]


def _timeline(calls):
    """A profiler's device timeline: a marker kernel, then each call's
    operations [(name, duration us)] back to back from 10 us after it,
    the next marker 10 us after the call's last operation ends.  An
    operation named with a leading "!" is a misplaced record: it starts
    where it stands but takes no time on this call's timeline."""
    mark, t, ops = bench_micro.MARK_KERNEL, 0.0, []
    for call in calls:
        ops.append((mark, t, 5.0))
        t += 15.0
        for name, dur in call:
            ops.append((name.lstrip("!"), t, dur))
            t += 0.0 if name.startswith("!") else dur
        t += 10.0
    ops.append((mark, t, 5.0))
    return ops


@pytest.mark.parametrize("misplaced", ["one round", "every round"])
def test_profile_split_catches_a_misplaced_activity(misplaced):
    """bench_micro's split of a profiled session at its marker kernels:
    each call's operations, their sum and the device span between its
    markers (here 10 us either side).  An activity placed in the wrong
    pass (a 4 ms copy recorded as starting inside `bilinear`'s window,
    its duration reaching past the next marker) makes that call's
    operations sum above its span, which one stream cannot do: the
    round is left out and the pass read from the slowest of its other
    rounds; with every round wrong the pass has no reading and the gate
    flags it."""
    bad = [1] if misplaced == "one round" else [0, 1, 2]
    sample = [110.0, 100.0, 100.0]
    calls = [[("sample", sample[r])] + ([("!Memcpy HtoD", 4000.0)]
                                        if r in bad else [])
             for r in range(3)]
    calls += [[("roll", 900.0), ("Memcpy HtoD", 1200.0)]] * 3
    rounds = bench_micro.split_rounds(_timeline(calls),
                                      ["bilinear", "deband"], 3)
    for r in range(3):
        n, busy, span = rounds["bilinear"][r]
        assert span == pytest.approx((sample[r] + 20.0) / 1e3)
        assert n == (2 if r in bad else 1)
        assert (busy > span) == (r in bad)
    assert rounds["deband"] == [(2, pytest.approx(2.1),
                                 pytest.approx(2.12))] * 3
    reading = bench_micro.pass_reading(rounds["bilinear"])
    passes = {"deband": {"ms": 2.2, "launches": 2, "device_ms": 2.1}}
    if misplaced == "one round":
        # the slowest round that fits its span, not the median
        assert reading == (1, pytest.approx(0.11), pytest.approx(0.13))
        passes["bilinear"] = {"ms": 0.12, "launches": 1, "device_ms": 0.11}
        assert bench_micro.profile_violations(passes) == []
        # a round that fits but is slow is not outvoted by the others
        slow = [(1, 0.1, 0.12), (1, 0.2, 0.22), (1, 0.1, 0.12)]
        assert bench_micro.pass_reading(slow) == (1, 0.2, 0.22)
        passes["bilinear"] = {"ms": 0.12, "launches": 1, "device_ms": 0.2}
        assert [n for n, _ in bench_micro.profile_violations(passes)] == \
            ["bilinear"]
    else:
        assert reading is None
        passes["bilinear"] = {"ms": 0.12, "launches": None,
                              "device_ms": None}
        assert bench_micro.profile_violations(passes) == \
            [("bilinear", "not profiled")]
    with pytest.raises(RuntimeError, match="markers"):
        bench_micro.split_rounds(_timeline(calls)[1:],
                                 ["bilinear", "deband"], 3)


def test_bench_micro_failing_pass_exits_1(monkeypatch, capsys, tmp_path):
    from libplacebo_tpu_torch.ops import deband

    def broken(*a, **k):
        raise RuntimeError("synthetic deband failure")
    monkeypatch.setattr(deband, "deband", broken)
    out = tmp_path / "bm.json"
    rc = bench_micro.main(["--cpu", "--size", "128x96", "--n", "1",
                           "--passes", "deband,bilinear", "--json", str(out)])
    text = capsys.readouterr().out
    assert rc == 1
    assert "SKIP" not in text
    assert "deband" in text and "FAILED (RuntimeError: synthetic deband " \
        "failure)" in text
    data = json.loads(out.read_text())
    assert set(data["failed"]) == {"deband", "deband_heavy"}
    assert data["passes"]["bilinear"]["ms"] > 0


def test_bench_micro_diff(micro, tmp_path, capsys):
    _, data = micro
    old = tmp_path / "old.json"
    old.write_text(json.dumps(data))
    assert bench_micro_diff.main([str(old), str(old)]) == 0
    slow = json.loads(json.dumps(data))
    for p in slow["passes"].values():
        p["ms"] = 2 * p["ms"] + 1.0
    new = tmp_path / "new.json"
    new.write_text(json.dumps(slow))
    assert bench_micro_diff.main([str(old), str(new)]) == 1
    regressed = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.endswith("REGRESSED")]
    # every compute pass flagged; the transfer passes not compared
    assert len(regressed) == len(data["passes"]) - 5
    assert not any(ln.startswith("tex_") for ln in regressed)
    assert bench_micro_diff.main([str(old)]) == 2


def test_committed_card_artifact():
    """libplacebo_tpu_torch/data/bench_micro_h100.json: every pass timed
    on the card at 1080p, with the card's line, launches and floors."""
    path = os.path.join(REPO, "libplacebo_tpu_torch", "data",
                        "bench_micro_h100.json")
    data = json.load(open(path))
    assert data["size"] == [1920, 1080] and data["failed"] == {}
    assert data["card"].startswith("NVIDIA H100"), data["card"]
    assert data["device"].startswith("cuda")
    for name in JAX_PASSES + ("k1 color_map_tail (flagship)",):
        p = data["passes"][name]
        assert p["ms"] > 0 and p["byte_floor_ms"] > 0, name
        if name not in bench_micro.NO_DEVICE_OPS:   # weave: a view
            assert p["launches"] >= 1 and p["device_ms"] > 0, name
    # one profiled call's device operations fit the time a call takes
    assert bench_micro.profile_violations(data["passes"]) == []


def test_gen_options_doc_equals_the_committed_table(tmp_path):
    committed = open(os.path.join(REPO, "docs", "options.md")).read()
    ours = gen_options_doc.generate()
    a, b = ours.splitlines(), committed.splitlines()
    assert len(a) == len(b)
    differ = [(x, y) for x, y in zip(a, b) if x != y]
    assert differ == [("from libplacebo_tpu_torch import Options",
                       "from libplacebo_tpu import Options")]
    out = tmp_path / "options.md"
    assert gen_options_doc.main(["--out", str(out)]) == 0
    assert out.read_text() == ours
    with pytest.raises(SystemExit):
        gen_options_doc.main(["--out", os.path.join(REPO, "docs",
                                                    "options.md")])
    assert open(os.path.join(REPO, "docs", "options.md")).read() == committed


# analogs of docs/API_PARITY.md's "yes" rows that do not resolve in the
# port, each with its ROADMAP line: none
PORT_UNRESOLVED = {}


def test_api_parity_every_analog_resolves():
    assert api_parity.unresolved() == PORT_UNRESOLVED
    assert api_parity.main([]) == 0


def test_api_parity_document_only_and_renames():
    """DOCUMENT_ONLY is exactly what the JAX package cannot resolve
    either, and the renames are needed: without them the port misses
    exactly the renamed analogs."""
    jax_bad = api_parity.unresolved("libplacebo_tpu", {}, skip=frozenset())
    assert set(jax_bad) == api_parity.DOCUMENT_ONLY
    bare = api_parity.unresolved(renames={})
    renamed = {t for t in api_parity.yes_targets()
               if set(t.split(".")) & set(api_parity.RENAMES)}
    assert set(bare) == renamed and renamed


def test_bench_playback_and_profile_stages_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "pb.json"
    assert bench_playback.main(["--cpu", "--frames", "3", "--size",
                                "128x64", "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    for fmt in ("yuv420p", "p010le"):
        ms = res["formats"][fmt]["ms_per_frame"]
        assert set(ms) == {"upload", "render_dispatch", "serial",
                           "queue_overlap"}
        assert all(v > 0 for v in ms.values())
    assert profile_stages.main(["1", "--size", "128x64", "--cpu"]) == 0
    text = capsys.readouterr().out
    for name, _, _ in profile_stages.variants():
        assert f"{name:20s}" in text, name
    assert "FAILED" not in text


def test_option_sweep_parity_on_two_ranks(tmp_path):
    out = tmp_path / "sweep.json"
    rc = option_sweep_parity.main([
        "--cpu", "--ranks", "2", "--keys",
        "deband,upscaler,dither,error_diffusion,peak_detect",
        "--out", str(out)])
    data = json.loads(out.read_text())
    assert rc == 0 and data["summary"]["failed"] == 0
    assert data["summary"]["device"] == "cpu"
    assert data["summary"]["mesh"] == {"data": 1, "spatial": 2}
    keys = {r["keys"][0] for r in data["rows"]}
    assert keys == {"deband", "upscaler", "dither", "error_diffusion",
                    "peak_detect"}
    # every probe rendered on both sides and agreed: a refusal on both
    # sides ("both_error") would count as parity with nothing rendered
    assert [r["status"] for r in data["rows"]] == ["ok"] * len(data["rows"])
    assert all(r["finite"] and r["diff_mean"] <= 5e-5 for r in data["rows"])
    # error diffusion renders on the replicated step, on the 8-bit target
    routes = {r["values"][0]: r["route"] for r in data["rows"]
              if r["keys"] == ["error_diffusion"]}
    assert routes["simple"] == "replicated"


def test_multichip_perf_against_the_jax_tools_counts(tmp_path):
    """Rank 0's collectives against the JAX tool's artifact
    (MULTICHIP_PERF.json, the same mesh, shapes and configs).  The halo
    bytes are equal; the differences, each explained:
      - collective-permutes: twice as many, each half as large — the
        port exchanges one frame at a time (2 frames a rank), XLA the
        batch at once;
      - hooks_temporal_halo: 12288 bytes more — the port extends the
        stateful hook's STORAGE texture by the hook's footprint on both
        sides of each frame (parallel/renderer.py, hooks_at), where XLA,
        compiling the whole step, drops the halo rows the program never
        reads;
      - all-reduces: the port's detection reduces each frame alone, two
        a frame (its 64-bin histogram with sum and max, 268 bytes, and a
        4-byte scalar), where XLA's reduces the batch in three."""
    jax_ = json.load(open(os.path.join(REPO, "MULTICHIP_PERF.json")))
    out = tmp_path / "mcp.json"
    assert multichip_perf.main(["--cpu", "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["mesh"] == jax_["mesh"] and res["shape"] == jax_["shape"]
    assert res["device"] == "cpu"
    per_rank = res["shape"]["batch"] // res["mesh"]["data"]
    for name, stats in res["configs"].items():
        assert res["routes"][name] == "halo", name
        j = jax_["configs"][name]
        assert set(stats) == set(j), (name, stats, j)
        cp, jcp = stats["collective-permute"], j["collective-permute"]
        extra = 12288 if name == "hooks_temporal_halo" else 0
        assert cp["total_bytes"] == jcp["total_bytes"] + extra, name
        assert cp["max_bytes"] == jcp["max_bytes"] // per_rank, name
        assert cp["count"] == per_rank * jcp["count"] + (4 if extra else 0)
        if "all-reduce" in j:
            ar = stats["all-reduce"]
            assert ar["count"] == 2 * per_rank
            assert ar["total_bytes"] == per_rank * (268 + 4)


def test_multihost_smoke_two_processes(capsys):
    assert multihost_smoke.main(["--cpu"]) == 0
    text = capsys.readouterr().out
    assert "MULTIHOST SMOKE: PASS" in text
    assert "MH-OK proc=0/2 device=cpu" in text and \
        "MH-OK proc=1/2 device=cpu" in text


@pytest.mark.parametrize("tool, argv", [
    (option_sweep_parity, ["--keys", "deband"]),
    (multichip_perf, []),
    (multihost_smoke, []),
])
def test_multi_device_tools_default_to_the_card(tool, argv, monkeypatch):
    """Without --cpu the multi-device tools render on the card: with no
    GPU they raise, and start no gloo ranks on the CPU."""
    import torch
    from libplacebo_tpu_torch import demos
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_ranks(*a, **k):
        raise AssertionError("spawned CPU ranks without --cpu")
    monkeypatch.setattr(demos, "run_ranks", no_ranks)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)

"""The check fails what it must: a run driven on the CPU (the look for a
card skipped) in a miniature checkout, with the timed path broken
underneath, comes out not correct under the committed limits, once for
each fault a cell can have; the same run unbroken comes out correct,
and so does not the control (the reference in bfloat16 in the program's
place).  The exchange between chips is no fault of these one-chip
cells."""
import pytest
import torch

import libplacebo_tpu_torch.render.renderer as renderer_mod
from libplacebo_tpu_torch.ops import peak_detect
from framebench import run

CELLS = ["play_1080p_hdr10", "transcode_2160p_hdr10", "play_2160p_hdr10"]


def _run(root, cell, seed=2 ** 35 + 11, control=None):
    args = run.parse(["--workload", cell, "--seed", str(seed),
                      "--seconds", "2", "--trace", "0"])
    return run.run_cell(args, device=torch.device("cpu"), root=root,
                        control=control)


def _state_unchanged(monkeypatch):
    """The renderer's step returns the peak state it was given."""
    real = peak_detect.finish_from_packed

    def stuck(packed, state, params):
        avg, mx, _ = real(packed, state, params)
        return avg, mx, state
    monkeypatch.setattr(peak_detect, "finish_from_packed", stuck)
    monkeypatch.setattr(peak_detect, "applied_stats",
                        lambda img, state, params, src_max_pq, group=None:
                        peak_detect.delayed_stats(state, src_max_pq)
                        + (state,))


def _render_patched(monkeypatch, alter):
    real = renderer_mod.Renderer.render

    def render(self, frame, target, params=None):
        return alter(real(self, frame, target, params).clone())
    monkeypatch.setattr(renderer_mod.Renderer, "render", render)


def _half_left_out(monkeypatch):
    """Half of each frame's rows are never rendered."""
    def alter(out):
        out[..., out.shape[-2] // 2:, :] = 0.0
        return out
    _render_patched(monkeypatch, alter)


def _answer_altered(monkeypatch):
    """One row of each frame is off by 8 codes where it is produced."""
    def alter(out):
        out[..., 3, :] = torch.clamp(out[..., 3, :] + 8 / 255, 0.0, 1.0)
        return out
    _render_patched(monkeypatch, alter)


FAULTS = {"state_unchanged": _state_unchanged,
          "half_left_out": _half_left_out,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(checkout, cell):
    res = _run(checkout, cell)
    assert res["correct"], res["numbers"]
    assert res["attempted"] >= 2 and res["failed"] == 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(checkout, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    res = _run(checkout, cell)
    assert not res["correct"], res["numbers"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(checkout, cell):
    res = _run(checkout, cell, control="bfloat16")
    assert not res["correct"], res["numbers"]

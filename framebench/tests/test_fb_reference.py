"""The reference against two witnesses outside it, at small sizes, for
each configuration, over seven frames of a ring of three, so the
carried peak state counts:

- the JAX package, the port's own reference, through golden outputs of
  its CPU render committed in `tests/data/` (its sizes in the file's
  name; the source planes are in the file too): each file's planes
  rendered by `libplacebo_tpu.Renderer` with the configuration's render
  parameters and target at that size, frame after frame so the peak
  state carries, and for the transcoder encoded by its `encode_color`
  and put in the encoder's planes by `harness.deploy.encoder_planes`;
- the program's CPU render, through the harness's own deployment.

Neither is bit for bit: the reference's curves, matrices and scalers
are written from their definitions, not from either implementation, so
a few values in a thousand land one code apart, and the perceptual
tail magnifies a rare one further.  A stage gone wrong moves most of a
frame (a chroma siting off by half a pixel: mean 23-28 codes)."""
import glob
import json
import os

import numpy as np
import pytest
import torch

import libplacebo_tpu_torch as lt
from framebench.harness import check, deploy, traffic
from framebench.reference import chain as ref
from framebench.reference import stages

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
GOLDENS = sorted(glob.glob(os.path.join(BENCH, "tests", "data", "*.npz")))
FRAMES, RING = 7, 3

# (configuration, source w, h, target w, h); the second and fourth run
# the program's tail through K1's plain version (a width that is a
# multiple of 128)
CASES = [
    ("mpv_ewa_hdr10_to_sdr4k", 40, 24, 80, 48),
    ("mpv_ewa_hdr10_to_sdr4k", 64, 48, 128, 96),
    ("ffmpeg_hdr10_4k_to_sdr1080p", 160, 96, 80, 48),
    ("ffmpeg_hdr10_4k_to_sdr1080p", 256, 128, 128, 64),
    ("mpv_ewa_hdr10_to_sdr4k", 48, 32, 48, 32),
]


def _config(name, w, h):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        cfg = json.load(f)
    cfg["target"].update(w=w, h=h)
    return cfg


def _mix(w, h):
    with open(os.path.join(BENCH, "traffic", "hdr10_1080p.json")) as f:
        t = json.load(f)
    t.update(width=w, height=h, ring=RING)
    return t


def _close(numbers):
    assert numbers["share_over_1"] < 2e-4, numbers
    assert numbers["share_differing"] < 0.03, numbers
    assert numbers["mean_abs_code_diff"] < 0.03, numbers
    assert numbers["max_row_mean_abs_diff"] < 0.1, numbers


class _Planes:
    """A Source's frames from the golden file."""

    def __init__(self, z):
        self.frames = [tuple(z[f"src{k}_{j}"] for j in range(3))
                       for k in range(RING)]
        self.h, self.w = self.frames[0][0].shape


@pytest.mark.parametrize("path", GOLDENS, ids=os.path.basename)
def test_reference_matches_the_jax_package(path):
    z = np.load(path)
    name, size = os.path.basename(path)[:-4].rsplit("_", 1)
    cfg = _config(name, *map(int, size.split("x")))
    history = [i % RING for i in range(FRAMES)]
    refs = check.reference_outputs(cfg, _Planes(z), history,
                                   list(range(FRAMES)), CPU)
    golden = {i: [torch.from_numpy(z[f"out{i}_{j}"].astype(np.int16))
                  for j in range(len(refs[i]))] for i in range(FRAMES)}
    _close(check.compare(cfg, golden, refs))


def test_goldens_cover_both_configurations():
    names = {os.path.basename(p).rsplit("_", 1)[0] for p in GOLDENS}
    assert names == {"mpv_ewa_hdr10_to_sdr4k", "ffmpeg_hdr10_4k_to_sdr1080p"}


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[3]}x{c[4]}")
def test_reference_matches_the_program(case):
    name, sw, sh, tw, th = case
    cfg = _config(name, tw, th)
    src = traffic.Source(_mix(sw, sh), 2 ** 40 + 3, CPU)
    d = deploy.Deployment(lt, cfg, src, CPU, 0)
    outs, history = {}, []
    for i in range(FRAMES):
        d.step(i, None)
        o = d.last
        outs[i] = o.clone() if isinstance(o, torch.Tensor) \
            else [p.clone() for p in o]
        history.append(src.key(i))
    positions = [0, 1, 3, 6]
    refs = check.reference_outputs(cfg, src, history, positions, CPU)
    _close(check.compare(cfg, {p: outs[p] for p in positions}, refs))


def test_peak_state_carries():
    """The state a later frame applies is not its first frame's: the
    delayed peak moves over the history."""
    m = {0: (torch.tensor(0.5), torch.tensor(0.7), torch.tensor(1.)),
         1: (torch.tensor(0.4), torch.tensor(0.75), torch.tensor(1.))}
    st = ref.peak_states(m, [0, 1] * 4, [0, 1, 2, 7])
    assert float(st[0].abs().sum()) == 0.0
    assert torch.allclose(st[1], torch.tensor([0.5, 0.7]))
    assert not torch.equal(st[2], st[7])


def test_unsupported_parameters_are_refused():
    cfg = _config("mpv_ewa_hdr10_to_sdr4k", 80, 48)
    for extra in ({"deband": True}, {"tone_mapping_function": "bt2390"}):
        c = dict(cfg, render_params=dict(cfg["render_params"], **extra))
        with pytest.raises(ref.Unsupported):
            ref.params_from(c)


def test_curves_and_matrices():
    x = torch.tensor([0.0, 0.5080784, 1.0])
    assert torch.allclose(stages.pq_to_nits(x),
                          torch.tensor([0.0, 100.0, 10000.0]), rtol=1e-4)
    assert torch.allclose(stages.nits_to_pq(stages.pq_to_nits(x)), x,
                          atol=1e-6)
    lb, lw = 0.001, 1.0
    v = stages.bt1886_delinearize(torch.tensor([lb, lw]), lb, lw)
    assert torch.allclose(v, torch.tensor([0.0, 1.0]), atol=1e-6)
    s = stages.srgb_delinearize(torch.tensor([lb, 0.214041 + lb * 0.785959,
                                              lw]), lb, lw)
    assert torch.allclose(s, torch.tensor([0.0, 0.5, 1.0]), atol=1e-5)
    rgb = torch.rand(3, 4, 5)
    for sys in stages.KR_KB:
        ycc = stages.rgb_to_ycbcr(rgb, sys, 10)
        assert torch.allclose(stages.ycbcr_to_rgb(ycc, sys, 10), rgb,
                              atol=1e-5)
    # limited-range 10-bit black and white
    ycc = torch.tensor([64.0, 512.0, 512.0])[:, None, None] / 1023
    assert torch.allclose(stages.ycbcr_to_rgb(ycc, "bt2020nc", 10),
                          torch.zeros(3, 1, 1), atol=1e-6)


def test_scalers():
    flat = torch.full((3, 6, 8), 0.25)
    assert torch.allclose(stages.ewa(flat, 12, 16), flat[:, :1, :1],
                          atol=1e-6)
    ramp = torch.arange(8.0).repeat(1, 4, 1)
    half = stages.hermite_scale(ramp, 2, 4)
    # a 2x Hermite downscale: taps 1/4 and 3/4 away, weights
    # 0.078125, 0.421875, 0.421875, 0.078125, edges repeated
    assert torch.allclose(half[0, 0], torch.tensor(
        [0.578125, 2.5, 4.5, 6.421875]), atol=1e-5)
    c = torch.arange(4.0).reshape(1, 1, 4)
    up = stages.merge_chroma(c, 1, 8, (-0.5, 0.0))
    assert torch.allclose(up[0, 0], torch.tensor(
        [0.0, 0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 3.0]))


def test_same_seed_same_frames():
    t = _mix(32, 16)
    a = traffic.Source(t, 2 ** 33 + 1, CPU)
    b = traffic.Source(t, 2 ** 33 + 1, CPU)
    c = traffic.Source(t, 2 ** 33 + 2, CPU)
    assert all((x == y).all() for x, y in zip(a.frames[1], b.frames[1]))
    assert not (a.frames[1][0] == c.frames[1][0]).all()
    lo, hi = t["luma_codes"]
    assert a.frames[0][0].min() >= lo and a.frames[0][0].max() < hi

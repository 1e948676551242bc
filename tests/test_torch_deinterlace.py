"""PyTorch port vs the JAX package: deinterlacing, and path D ("1080i
broadcast deinterlaced to 4K": bwdif and H.274 grain on every plane,
then config 2's path) end to end, on the CPU at small sizes.

The same inputs, made from a seed, go through the JAX function (jitted,
as the renderer runs it) and its port.  Tolerances, with the measured
figure beside each (CPU, this file's inputs):
- `deinterlace`: every algorithm (weave, bob, yadif with and without
  the spatial check, bwdif temporal and intra-only) x field x first
  field, with both neighbor frames and with none: exact (bwdif's
  products fused where the reference's jitted lowering fuses them,
  `ops/deinterlace.py`); bwdif with one neighbor: exact, but for the
  first field without its next frame, atol 1.2e-7 (measured 6e-8 on
  0.47% of values);
- a 4:2:0 frame's planes through the renderer's merge: exact, each
  plane keeping its own row parity;
- path D, 3 chained field renders 64x128 -> 128x256 (frame 1's top and
  bottom fields, frame 2's top field, each with both neighbors and an
  H.274 SEI with a new seed each frame) through one Renderer against
  the reference's: the flagship's gate, no value more than 1 LSB apart
  and fewer than 1e-3 differing (measured 0-1.0e-5, PSNR >= 98 dB),
  two plans (one a field).
The `cuda`-marked test holds path D's K1 launch against its plain
version on the card.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libplacebo_tpu.core import colorspace as jcs
from libplacebo_tpu.core.film_grain import FilmGrainData as JGrain
from libplacebo_tpu.core.film_grain import H274GrainData as JH274
from libplacebo_tpu.ops import deinterlace as jdi
from libplacebo_tpu.render.frame import frame_from_yuv420p as j_frame
from libplacebo_tpu.render.renderer import RenderParams as JParams
from libplacebo_tpu.render.renderer import Renderer as JRenderer
from libplacebo_tpu.render.renderer import Target as JTarget

import libplacebo_tpu_torch as lt
from libplacebo_tpu_torch.core import colorspace as tcs
from libplacebo_tpu_torch.ops import deinterlace as tdi
from libplacebo_tpu_torch.ops.cuda import color_map as k1
from libplacebo_tpu_torch.render import renderer as trender

LSB = 1.0 / 255.0
SRC_H, SRC_W = 64, 128

# path D's SEI: luma and chroma models (two luma intensity intervals)
H274_MODELS = dict(
    model_id=0, blending_mode_id=0, log2_scale_factor=2,
    component_model_present=(True, True, True),
    num_intensity_intervals=(2, 1, 1), num_model_values=(3, 2, 2),
    intensity_interval_lower_bound=((0, 128), (0,), (0,)),
    intensity_interval_upper_bound=((127, 255), (255,), (255,)),
    comp_model_value=(((100, 8, 8), (60, 10, 6)), ((60, 6),), ((60, 6),)))

_CASES = [("weave", False), ("bob", False), ("bwdif", False),
          ("yadif", False), ("yadif", True)]


def _planes(seed, shape=(2, 24, 40)):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, shape) / 255.0).astype(np.float32)
            for _ in range(3)]


@pytest.mark.parametrize("neighbors", [True, False])
@pytest.mark.parametrize("first", ["TOP", "BOTTOM"])
@pytest.mark.parametrize("field", ["TOP", "BOTTOM"])
@pytest.mark.parametrize("algo,skip", _CASES)
def test_deinterlace_matches_jax(algo, skip, field, first, neighbors):
    """Every algorithm x field x first field, with both neighbors and
    without (bwdif then interpolates within the field): exact."""
    cur, prev, nxt = _planes(1)
    jp = jdi.DeinterlaceParams(jdi.DeinterlaceAlgo(algo), skip)
    tp = tdi.DeinterlaceParams(tdi.DeinterlaceAlgo(algo), skip)
    jf, jff = jdi.Field[field], jdi.Field[first]
    ref = np.asarray(jax.jit(lambda c, p, n: jdi.deinterlace(
        c, jf, jp, prev=p if neighbors else None,
        next=n if neighbors else None, first_field=jff))(
            jnp.asarray(cur), jnp.asarray(prev), jnp.asarray(nxt)))
    out = tdi.deinterlace(
        torch.from_numpy(cur), tdi.Field[field], tp,
        prev=torch.from_numpy(prev) if neighbors else None,
        next=torch.from_numpy(nxt) if neighbors else None,
        first_field=tdi.Field[first]).numpy()
    np.testing.assert_array_equal(out, ref)
    keep = np.arange(cur.shape[-2]) % 2 == tdi.Field[field].value
    np.testing.assert_array_equal(out[..., keep, :], cur[..., keep, :])


@pytest.mark.parametrize("missing", ["prev", "next"])
def test_bwdif_one_neighbor_matches_jax(missing):
    """bwdif with one neighbor missing: intra-only for the field whose
    temporal partner is gone, temporal for the other — exact but for
    the first field without its next frame (the last frame of a
    stream): atol 1.2e-7, measured 6e-8 on 0.47% of values (XLA lowers
    that graph, where the next frame is the current one, otherwise;
    ROADMAP §3)."""
    cur, prev, nxt = _planes(2)
    jp = jdi.DeinterlaceParams(jdi.DeinterlaceAlgo.BWDIF)
    tp = tdi.DeinterlaceParams(tdi.DeinterlaceAlgo.BWDIF)
    for field in ("TOP", "BOTTOM"):
        kw_j = dict(prev=None if missing == "prev" else jnp.asarray(prev),
                    next=None if missing == "next" else jnp.asarray(nxt))
        kw_t = dict(prev=None if missing == "prev" else
                    torch.from_numpy(prev),
                    next=None if missing == "next" else torch.from_numpy(nxt))
        ref = np.asarray(jax.jit(lambda c: jdi.deinterlace(
            c, jdi.Field[field], jp, first_field=jdi.Field.TOP,
            **kw_j))(jnp.asarray(cur)))
        out = tdi.deinterlace(torch.from_numpy(cur), tdi.Field[field], tp,
                              first_field=tdi.Field.TOP, **kw_t).numpy()
        if missing == "next" and field == "TOP":
            np.testing.assert_allclose(out, ref, rtol=0, atol=1.2e-7)
        else:
            np.testing.assert_array_equal(out, ref)


def _yuv(n, seed=3, h=SRC_H, w=SRC_W):
    rng = np.random.default_rng(seed)
    return [((rng.random((h, w)) * 219 + 16).astype(np.uint8),
             (rng.random((h // 2, w // 2)) * 224 + 16).astype(np.uint8),
             (rng.random((h // 2, w // 2)) * 224 + 16).astype(np.uint8))
            for _ in range(n)]


def _sources(mod, yuvs, device=None):
    """Path D's source frames: 8-bit limited BT.709 BT.1886 yuv420p,
    woven fields."""
    color = mod.ColorSpace(mod.ColorPrimaries.BT_709,
                           mod.ColorTransfer.BT_1886)
    rep = mod.ColorRepr(sys=mod.ColorSystem.BT_709,
                        levels=mod.ColorLevels.LIMITED,
                        bits=mod.BitEncoding(8, 8, 0))
    if mod is jcs:
        return [j_frame(*f, color=color, repr=rep) for f in yuvs]
    return [lt.frame_from_yuv420p(*f, color=color, repr=rep, device=device)
            for f in yuvs]


def path_d_field(mod, sources, k, field, seed):
    """Source frame k shown as `field` (top field first) with its
    neighbors and an H.274 SEI of seed `seed`."""
    f = copy.copy(sources[k])
    if mod is jcs:
        f.field, f.first_field = jdi.Field[field], jdi.Field.TOP
        f.film_grain = JGrain(type="h274", seed=seed,
                              h274=JH274(**H274_MODELS))
    else:
        f.field, f.first_field = lt.Field[field], lt.Field.TOP
        f.film_grain = lt.FilmGrainData(type="h274", seed=seed,
                                        h274=lt.H274GrainData(**H274_MODELS))
    f.prev = sources[k - 1] if k > 0 else None
    f.next = sources[k + 1] if k + 1 < len(sources) else None
    return f


# path D's renders on the CPU: frame 1's two fields and frame 2's top
_RENDERS = ((1, "TOP"), (1, "BOTTOM"), (2, "TOP"))


def test_path_d_three_fields(monkeypatch):
    """Path D over 3 chained field renders against the reference's
    renderer (its fused tail, as K1's): no value more than 1 LSB apart,
    fewer than 1e-3 differing, all tails on K1, one plan a field."""
    monkeypatch.setenv("LPTPU_FUSED_COLORMAP", "1")
    yuvs = _yuv(4)
    js, ts = _sources(jcs, yuvs), _sources(tcs, yuvs, "cpu")
    jt = JTarget(w=2 * SRC_W, h=2 * SRC_H, color=jcs.CSP_SRGB, bit_depth=8)
    tt = lt.Target(w=2 * SRC_W, h=2 * SRC_H, color=lt.CSP_SRGB, bit_depth=8)
    jp = JParams(deinterlace=jdi.DeinterlaceParams(jdi.DeinterlaceAlgo.BWDIF))
    tp = lt.RenderParams(deinterlace=lt.DeinterlaceParams(
        lt.DeinterlaceAlgo.BWDIF))
    jr, tr = JRenderer(), lt.Renderer(device="cpu")
    trender.k1_tails = trender.plain_tails = trender.ineligible_tails = 0
    for k, field in _RENDERS:
        ref = np.asarray(jr._render_once(
            path_d_field(jcs, js, k, field, 500 + k), jt, jp))
        out = tr.render(path_d_field(tcs, ts, k, field, 500 + k), tt,
                        tp).numpy()
        assert out.shape == ref.shape == (3, 2 * SRC_H, 2 * SRC_W)
        d = np.abs(out.astype(np.float64) - ref)
        assert d.max() <= LSB + 1e-6 and (d > 1e-6).mean() < 1e-3, \
            (d.max() / LSB, (d > 1e-6).mean())
    assert (trender.k1_tails, trender.plain_tails,
            trender.ineligible_tails) == (3, 0, 0)
    assert len(tr._cache) == 2


def test_merge_keeps_each_planes_parity():
    """A 4:2:0 field's planes through the renderer's merge (bwdif, then
    H.274 grain on every plane, then the chroma merge) against the
    reference's: exact — the 32-row chroma planes use their own rows'
    parity."""
    yuvs = _yuv(3, seed=8)
    js, ts = _sources(jcs, yuvs), _sources(tcs, yuvs, "cpu")
    jf = path_d_field(jcs, js, 1, "BOTTOM", 7)
    tf_ = path_d_field(tcs, ts, 1, "BOTTOM", 7)
    jp = JParams(deinterlace=jdi.DeinterlaceParams(jdi.DeinterlaceAlgo.BWDIF))
    tp = lt.RenderParams(deinterlace=lt.DeinterlaceParams(
        lt.DeinterlaceAlgo.BWDIF))
    mk = jf.meta_key()[0]
    jr, tr = JRenderer(), lt.Renderer(device="cpu")

    def jmerge(planes, prev, nxt):
        return jr._merge_planes(
            planes, (mk, jf.repr.sys), jp, field=jf.field,
            first_field=jf.first_field, prev_planes=prev, next_planes=nxt,
            h274_grain=jf.film_grain)[0]
    ref = np.asarray(jax.jit(jmerge)(
        tuple(p.data for p in jf.planes),
        tuple(p.data for p in jf.prev.planes),
        tuple(p.data for p in jf.next.planes)))
    inputs = tr._frame_inputs(tf_, tp)
    out = tr._merge_planes(
        [p.data for p in tf_.planes], tf_.meta_key()[0], tp,
        fields=(tf_.field, tf_.first_field, inputs.prev_planes,
                inputs.next_planes),
        h274=(tf_.film_grain, inputs.h274_tables, True))[0].numpy()
    np.testing.assert_array_equal(out, ref)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_path_d_k1_matches_plain_on_card(cuda_device, monkeypatch):
    """Path D's K1 launch (pass-through with dither) on the card vs its
    plain version: within 1 LSB on < 1e-3 of values; the GPU fields vs
    the CPU fields: mean < 1e-4, more than 1 LSB on <= 5e-4."""
    seen = []
    real = k1.color_map_tail

    def capture(img, plan, tone, lut):
        seen.append((img.clone(), plan, tone, lut))
        return real(img, plan, tone, lut)
    monkeypatch.setattr(k1, "color_map_tail", capture)
    yuvs = _yuv(4)
    gs, cs = _sources(tcs, yuvs, cuda_device), _sources(tcs, yuvs, "cpu")
    tt = lt.Target(w=2 * SRC_W, h=2 * SRC_H, color=lt.CSP_SRGB, bit_depth=8)
    tp = lt.RenderParams(deinterlace=lt.DeinterlaceParams(
        lt.DeinterlaceAlgo.BWDIF))
    rg, rc = lt.Renderer(device=cuda_device), lt.Renderer(device="cpu")
    for k, field in _RENDERS:
        g = rg.render(path_d_field(tcs, gs, k, field, 500 + k), tt, tp)
        c = rc.render(path_d_field(tcs, cs, k, field, 500 + k), tt,
                      tp).numpy()
        d = np.abs(g.cpu().numpy().astype(np.float64) - c)
        assert d.mean() < 1e-4 and (d > LSB + 1e-6).mean() <= 5e-4
    img, plan, tone, lut = seen[1]
    assert plan.instance.kind == 0 and lut is not None
    out, _ = real(img, plan, tone, lut)
    ref, _ = k1.tail_plain(img, plan, tone, lut)
    diff = (out - ref).abs()
    assert diff.max().item() <= LSB + 1e-6
    assert (diff > 1e-6).float().mean().item() < 1e-3


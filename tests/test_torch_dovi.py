"""PyTorch port vs the JAX package: Dolby Vision — the RPU parser and
writer, the reshaping and the decode, and path C ("Dolby Vision profile
5 on an SDR display") end to end, on the CPU at small sizes.

The same inputs (the committed RPU fixtures in tests/golden/dovi/, 10-bit
signals made from a seed) go through the JAX function, jitted as the
renderer runs it, and its port.  Tolerances, with the measured figure
beside each (CPU, this file's inputs); ROADMAP §3 records every one that
is not exact:
- parse_rpu, write_rpu, rpu_to_dovi, hdr_metadata_from_rpu, pack_dovi:
  equal field for field, the written bytes equal;
- the renderer's reshape (`dovi_reshape_packed`) and decode (with the
  packed RPU): exact on every fixture and on a synthetic RPU with
  multi-piece curves and order-3 MMR;
- the structured decode (`dovi_reshape` + the constant matrices, off the
  renderer's path): atol 5e-6 (measured 1.9e-6 on profile 5: XLA and
  `mix` fuse a different product of a constant matrix row);
- path C, 3 chained frames 64x128 -> 128x256, each with a different RPU,
  through one Renderer (one plan): decode and linearize are exact, the
  EWA's summation order (F1) differs by <= 7.6e-6, and K1's perceptual
  tail magnifies it: 8.2-10.6e-4 of the 8-bit values differ (gate
  1.2e-3), <= 2e-5 of them by more than 1 LSB (up to 7 LSB on soft-clip
  knife edges; gate 5e-5), PSNR 76.2-79.0 dB (gate 75); fed the
  reference's EWA output, the port's frame equals the reference's.
The `cuda`-marked test holds path C's K1 launch against its plain
version on the card.  `PYTHONPATH=. python tests/test_torch_dovi.py`
prints the path's figures stage by stage.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from libplacebo_tpu.core import colorspace as jcs
from libplacebo_tpu.ops import color as jcolor
from libplacebo_tpu.ops import dovi as jdovi
from libplacebo_tpu.ops import polar as jpolar
from libplacebo_tpu.render.frame import frame_from_yuv420p as j_frame
from libplacebo_tpu.render.renderer import RenderParams as JParams
from libplacebo_tpu.render.renderer import Renderer as JRenderer
from libplacebo_tpu.render.renderer import Target as JTarget
from libplacebo_tpu.utils import dolbyvision as jdv

import libplacebo_tpu_torch as lt
from libplacebo_tpu_torch import carry
from libplacebo_tpu_torch.core import colorspace as tcs
from libplacebo_tpu_torch.ops import color as tcolor
from libplacebo_tpu_torch.ops import dovi as tdovi
from libplacebo_tpu_torch.ops import polar as tpolar
from libplacebo_tpu_torch.ops.cuda import color_map as k1
from libplacebo_tpu_torch.render import renderer as trender
from libplacebo_tpu_torch.utils import dolbyvision as tdv

LSB = 1.0 / 255.0
SRC_H, SRC_W = 64, 128
FIXTURES = ("profile5", "profile7", "profile81")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "dovi")


def _fixture(name):
    with open(os.path.join(GOLDEN, name + ".bin"), "rb") as f:
        return f.read()


def _signal(seed=0, h=SRC_H, w=SRC_W):
    """A 10-bit full-range signal, normalized."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1024, (3, h, w)) / 1023.0).astype(np.float32)


def _as_plain(v):
    """Nested dataclasses / tuples / arrays as nested lists of numbers."""
    if dataclasses.is_dataclass(v):
        return {k: _as_plain(x) for k, x in dataclasses.asdict(v).items()}
    if isinstance(v, dict):
        return {k: _as_plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, np.ndarray)):
        return [_as_plain(x) for x in v]
    return v


def _synthetic_dovi(mod, partial=False):
    """A DoviMetadata with multi-piece curves mixing polynomials and MMR
    of orders 1-3 (the fixtures carry at most order 2); `partial` leaves
    the last component without a curve (it is only clipped)."""
    r = np.random.default_rng(5)

    def comp(n, methods, orders):
        pivots = tuple(sorted([0.0, 1.0] + list(r.random(n - 2))))
        return {"num_pivots": n, "pivots": pivots, "method": tuple(methods),
                "poly_coeffs": tuple(tuple(r.normal(0, 0.5, 3))
                                     for _ in range(n - 1)),
                "mmr_order": tuple(orders),
                "mmr_constant": tuple(r.normal(0, 0.3, n - 1)),
                "mmr_coeffs": tuple(tuple(tuple(r.normal(0, 0.3, 7))
                                          for _ in range(o))
                                    for o in orders)}
    return mod.DoviMetadata(
        nonlinear_offset=(0.0, 0.5, 0.5),
        nonlinear=((1.0, 0.0, 1.5), (1.0, -0.2, -0.5), (1.0, 1.8, 0.0)),
        linear=((0.9, 0.1, 0.0), (0.05, 0.9, 0.05), (0.0, 0.1, 0.9)),
        comp=(comp(5, [0, 1, 0, 1], [1, 3, 1, 2]),
              comp(3, [1, 1], [3, 2]),
              {"num_pivots": 1} if partial else comp(2, [1], [3])))


def _metadata(name):
    """(reference DoviMetadata, port DoviMetadata) of a fixture or of
    the synthetic RPU."""
    if name in ("synthetic", "partial"):
        return (_synthetic_dovi(jcs, name == "partial"),
                _synthetic_dovi(tcs, name == "partial"))
    buf = _fixture(name)
    return (jdv.rpu_to_dovi(jdv.parse_rpu(buf)),
            tdv.rpu_to_dovi(tdv.parse_rpu(buf)))


# ---------------------------------------------------------------------------
# The RPU parser and writer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", FIXTURES)
def test_rpu_fixture_parses_like_jax(name):
    """Every field of the parsed RPU (curves, matrices, extension blocks,
    profile 7's NLQ data) equals the reference parser's."""
    buf = _fixture(name)
    assert _as_plain(tdv.parse_rpu(buf)) == _as_plain(jdv.parse_rpu(buf))


@pytest.mark.parametrize("name", FIXTURES)
def test_rpu_mapping_matches_jax(name):
    """rpu_to_dovi, hdr_metadata_from_rpu (its L1 block) and pack_dovi
    equal the reference's."""
    buf = _fixture(name)
    jmd, tmd = _metadata(name)
    assert _as_plain(tmd) == _as_plain(jmd)
    jh = jdv.hdr_metadata_from_rpu(jcs.HdrMetadata(), buf)
    th = tdv.hdr_metadata_from_rpu(tcs.HdrMetadata(), buf)
    assert _as_plain(th) == _as_plain(jh)
    # profile 5's fixture carries no L1 block
    assert (th.max_pq_y > 0) == (name != "profile5")
    for a, b in zip(tdovi.pack_dovi(tmd), jdovi.pack_dovi(jmd)):
        np.testing.assert_array_equal(a, np.asarray(b))
    # the carried copy of the reference's metadata packs the same
    carried = carry.dovi_from_fields(dataclasses.asdict(jmd))
    for a, b in zip(tdovi.pack_dovi(carried), tdovi.pack_dovi(tmd)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", FIXTURES)
def test_write_rpu_round_trip(name):
    """write_rpu of the parsed fixture writes the reference writer's
    bytes, and parses back to the same RPU."""
    buf = _fixture(name)
    rpu = tdv.parse_rpu(buf)
    out = tdv.write_rpu(rpu)
    assert out == jdv.write_rpu(jdv.parse_rpu(buf))
    assert _as_plain(tdv.parse_rpu(out)) == _as_plain(rpu)


def test_rpu_errors_and_garbage():
    """Garbage raises RpuError; hdr_metadata_from_rpu leaves the metadata
    unchanged on it, as the reference does."""
    with pytest.raises(tdv.RpuError):
        tdv.parse_rpu(b"\x00\x01\x02")
    hdr = tcs.HdrMetadata(max_luma=1000.0)
    assert tdv.hdr_metadata_from_rpu(hdr, b"\x00\x01\x02") == hdr


# ---------------------------------------------------------------------------
# Reshaping and decode
# ---------------------------------------------------------------------------

# the reference's packed functions evaluate every segment of every order
# whatever the RPU, so one compiled program serves every test
_J_RESHAPE = jax.jit(jdovi.dovi_reshape_packed)
_J_DECODE = jax.jit(lambda a, p: jcolor.decode_color(
    a, jcs.ColorRepr(sys=jcs.ColorSystem.DOLBYVISION), dovi_packed=p))


@pytest.mark.parametrize("name", FIXTURES + ("synthetic", "partial"))
def test_reshape_packed_matches_jax(name):
    """The renderer's reshape with the packed RPU: exact."""
    jmd, tmd = _metadata(name)
    x = _signal(1)
    ref = np.asarray(_J_RESHAPE(jnp.asarray(x), jdovi.pack_dovi(jmd)))
    out = tdovi.dovi_reshape_packed(torch.from_numpy(x),
                                    tdovi.pack_dovi(tmd)).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("name", FIXTURES + ("synthetic",))
def test_decode_packed_matches_jax(name):
    """decode_color of a Dolby Vision frame with the packed RPU (reshape,
    nonlinear matrix less its offset, PQ, linear matrix, PQ back):
    exact."""
    jmd, tmd = _metadata(name)
    x = _signal(2)
    trep = tcs.ColorRepr(sys=tcs.ColorSystem.DOLBYVISION, dovi=tmd,
                         bits=tcs.BitEncoding(10, 10, 0))
    ref = np.asarray(_J_DECODE(jnp.asarray(x), jdovi.pack_dovi(jmd)))
    out = tcolor.decode_color(torch.from_numpy(x), trep,
                              dovi_packed=tdovi.pack_dovi(tmd)).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("name", FIXTURES + ("partial",))
def test_decode_structured_matches_jax(name):
    """The structured decode (no packed RPU: the reshape of the metadata
    and color_repr_decode's transform): atol 5e-6, and the reshape alone
    exact."""
    jmd, tmd = _metadata(name)
    x = _signal(3)
    jrep = jcs.ColorRepr(sys=jcs.ColorSystem.DOLBYVISION, dovi=jmd,
                         bits=jcs.BitEncoding(10, 10, 0))
    trep = tcs.ColorRepr(sys=tcs.ColorSystem.DOLBYVISION, dovi=tmd,
                         bits=tcs.BitEncoding(10, 10, 0))
    ref = np.asarray(jax.jit(lambda a: jcolor.decode_color(a, jrep))(
        jnp.asarray(x)))
    out = tcolor.decode_color(torch.from_numpy(x), trep).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=5e-6)
    ref = np.asarray(jax.jit(lambda a: jdovi.dovi_reshape(a, jmd))(
        jnp.asarray(x)))
    out = tdovi.dovi_reshape(torch.from_numpy(x), tmd).numpy()
    np.testing.assert_array_equal(out, ref)


def test_decode_transform_and_guesses_match_jax():
    """color_repr_decode's pre-matrix for Dolby Vision (the nonlinear
    matrix, no level offsets: the RPU carries the levels), and the
    YCbCr-likeness and levels guess of the system."""
    jmd, tmd = _metadata("profile5")
    for bits in (8, 10, 12):
        jt_, _ = jcs.color_repr_decode(jcs.ColorRepr(
            sys=jcs.ColorSystem.DOLBYVISION, dovi=jmd,
            bits=jcs.BitEncoding(bits, bits, 0)))
        tt_, _ = tcs.color_repr_decode(tcs.ColorRepr(
            sys=tcs.ColorSystem.DOLBYVISION, dovi=tmd,
            bits=tcs.BitEncoding(bits, bits, 0)))
        np.testing.assert_array_equal(tt_.mat.m, jt_.mat.m)
        np.testing.assert_array_equal(tt_.c, jt_.c)
    assert tcs.system_is_ycbcr_like(tcs.ColorSystem.DOLBYVISION) == \
        jcs.system_is_ycbcr_like(jcs.ColorSystem.DOLBYVISION)
    assert tcs.levels_guess(tcs.ColorRepr(
        sys=tcs.ColorSystem.DOLBYVISION)).value == jcs.levels_guess(
            jcs.ColorRepr(sys=jcs.ColorSystem.DOLBYVISION)).value


# ---------------------------------------------------------------------------
# Path C end to end
# ---------------------------------------------------------------------------

def path_c_rpus(n):
    """n RPUs, a new one every frame, written with the port's write_rpu:
    profile 5's fixture with an L1 block (profile 8.1's fixture's, as a
    stream's RPUs carry one), its chroma MMR constant and coefficients
    scaled frame by frame — the L1 block, and so the plan, unchanged."""
    rpu = tdv.parse_rpu(_fixture("profile5"))
    l1 = tdv.parse_rpu(_fixture("profile81")).ext_blocks[0]
    assert l1.level == 1
    rpu = dataclasses.replace(rpu, ext_blocks=(l1,))
    out = []
    for k in range(n):
        c1 = rpu.curves[1]
        c1 = dataclasses.replace(
            c1, mmr_constant=tuple(v + 200000 * k for v in c1.mmr_constant),
            mmr_coef=tuple(tuple(tuple(int(x * (1 + 0.1 * k)) for x in row)
                                 for row in piece) for piece in c1.mmr_coef))
        out.append(tdv.write_rpu(dataclasses.replace(
            rpu, curves=(rpu.curves[0], c1, rpu.curves[2]))))
    return out


def _yuv10(n, seed=3, h=SRC_H, w=SRC_W):
    rng = np.random.default_rng(seed)
    return [tuple(rng.integers(0, 1024, s).astype(np.uint16)
                  for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
            for _ in range(n)]


def _path_c_frame(mod, yuv, buf, device=None):
    """Path C's frame in the reference package (mod = jcs) or the port,
    its RPU parsed from `buf`."""
    if mod is jcs:
        md = jdv.rpu_to_dovi(jdv.parse_rpu(buf))
        hdr = jdv.hdr_metadata_from_rpu(jcs.HdrMetadata(), buf)
    else:
        md = tdv.rpu_to_dovi(tdv.parse_rpu(buf))
        hdr = tdv.hdr_metadata_from_rpu(tcs.HdrMetadata(), buf)
    color = mod.ColorSpace(mod.ColorPrimaries.BT_2020, mod.ColorTransfer.PQ,
                           hdr)
    rep = mod.ColorRepr(sys=mod.ColorSystem.DOLBYVISION,
                        levels=mod.ColorLevels.FULL,
                        bits=mod.BitEncoding(10, 10, 0), dovi=md)
    if mod is jcs:
        return j_frame(*yuv, color=color, repr=rep, bit_depth=10)
    return lt.frame_from_yuv420p(*yuv, color=color, repr=rep, bit_depth=10,
                                 device=device)


def _render_path_c(monkeypatch, n=3):
    """Path C over n chained frames through one Renderer each; returns
    [(port, reference)], the port's tail counts, its plan count, and the
    reference's EWA output of frame 0."""
    monkeypatch.setenv("LPTPU_FUSED_COLORMAP", "1")
    ewa = []
    real = jpolar.sample_polar

    def capture(img, *a, **kw):
        out = real(img, *a, **kw)
        jax.debug.callback(lambda v: ewa.append(np.array(v)), out)
        return out
    monkeypatch.setattr(jpolar, "sample_polar", capture)
    jt = JTarget(w=2 * SRC_W, h=2 * SRC_H, color=jcs.CSP_SRGB, bit_depth=8)
    tt = lt.Target(w=2 * SRC_W, h=2 * SRC_H, color=lt.CSP_SRGB, bit_depth=8)
    jr, tr = JRenderer(), lt.Renderer(device="cpu")
    trender.k1_tails = trender.plain_tails = trender.ineligible_tails = 0
    res = []
    for yuv, buf in zip(_yuv10(n), path_c_rpus(n)):
        ref = np.asarray(jr._render_once(_path_c_frame(jcs, yuv, buf), jt,
                                         JParams(upscaler="ewa_lanczos")))
        out = tr.render(_path_c_frame(tcs, yuv, buf, "cpu"), tt,
                        lt.RenderParams(upscaler="ewa_lanczos")).numpy()
        res.append((out, ref))
    counts = (trender.k1_tails, trender.plain_tails,
              trender.ineligible_tails)
    monkeypatch.setattr(jpolar, "sample_polar", real)
    return res, counts, len(tr._cache), ewa[0], tt


def test_path_c_three_frames(monkeypatch):
    """Path C (10-bit Dolby Vision profile 5, a new RPU each frame ->
    3840x2160-shaped 8-bit sRGB, EWA, K1's <spline, perceptual> tail
    with dither) over 3 chained frames 64x128 -> 128x256 against the
    reference's renderer: differing on <= 1.2e-3 of values, more than 1
    LSB on <= 5e-5, PSNR >= 75 dB, through one plan; the RPUs change the
    frames; with the reference's EWA output fed in, frame 0 is exact."""
    res, counts, plans, jewa, tt = _render_path_c(monkeypatch)
    for out, ref in res:
        assert out.shape == ref.shape == (3, 2 * SRC_H, 2 * SRC_W)
        d = np.abs(out.astype(np.float64) - ref)
        psnr = 10 * np.log10(1.0 / max((d ** 2).mean(), 1e-20))
        assert (d > 1e-6).mean() <= 1.2e-3, (d > 1e-6).mean()
        assert (d > LSB + 1e-6).mean() <= 5e-5 and psnr >= 75.0, psnr
    assert counts == (3, 0, 0) and plans == 1
    # a new RPU changes the frame (the same plan does not bake frame 1's)
    assert not np.array_equal(res[0][1][1:], res[1][1][1:])
    monkeypatch.setattr(tpolar, "sample_polar",
                        lambda img, *a, **kw: torch.from_numpy(jewa.copy()))
    out = lt.Renderer(device="cpu").render(
        _path_c_frame(tcs, _yuv10(1)[0], path_c_rpus(1)[0], "cpu"), tt,
        lt.RenderParams(upscaler="ewa_lanczos")).numpy()
    np.testing.assert_array_equal(out, res[0][1])


def test_dolby_vision_needs_its_metadata():
    """A Dolby Vision repr without an RPU refuses, as the reference's
    decode does."""
    with pytest.raises(ValueError, match="dovi metadata"):
        tcolor.decode_color(torch.zeros(3, 2, 2),
                            tcs.ColorRepr(sys=tcs.ColorSystem.DOLBYVISION))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_path_c_k1_matches_plain_on_card(cuda_device, monkeypatch):
    """Path C's K1 launch (spline, perceptual, with dither) on the card
    vs its plain version on the same input: within 1 LSB on < 1e-3 of
    values; the GPU frames vs the CPU frames: mean < 1e-4, more than 1
    LSB on <= 5e-4."""
    seen = []
    real = k1.color_map_tail

    def capture(img, plan, tone, lut):
        seen.append((img.clone(), plan, tone, lut))
        return real(img, plan, tone, lut)
    monkeypatch.setattr(k1, "color_map_tail", capture)
    tt = lt.Target(w=2 * SRC_W, h=2 * SRC_H, color=lt.CSP_SRGB, bit_depth=8)
    p = lt.RenderParams(upscaler="ewa_lanczos")
    rg, rc = lt.Renderer(device=cuda_device), lt.Renderer(device="cpu")
    for yuv, buf in zip(_yuv10(2), path_c_rpus(2)):
        g = rg.render(_path_c_frame(tcs, yuv, buf, cuda_device), tt, p)
        c = rc.render(_path_c_frame(tcs, yuv, buf, "cpu"), tt, p).numpy()
        d = np.abs(g.cpu().numpy().astype(np.float64) - c)
        assert d.mean() < 1e-4 and (d > LSB + 1e-6).mean() <= 5e-4
    img, plan, tone, lut = seen[1]
    mode = plan.instance
    assert (k1.G_DYNAMIC[mode.curve], k1.G_GAMUTS[mode.gamut]) == \
        ("spline", "perceptual") and lut is not None
    out, _ = real(img, plan, tone, lut)
    ref, _ = k1.tail_plain(img, plan, tone, lut)
    diff = (out - ref).abs()
    assert diff.max().item() <= LSB + 1e-6
    assert (diff > 1e-6).float().mean().item() < 1e-3


def _measure():
    """Path C's figures behind the gate, and where they enter: per frame
    the port against the reference renderer at the decode's input and
    output, after the PQ linearize and after the EWA, then the frame."""
    import libplacebo_tpu.ops.color as jcol
    import libplacebo_tpu_torch.ops.color as tcol
    os.environ["LPTPU_FUSED_COLORMAP"] = "1"
    seen = {}

    def wrap(mod, name, key, on_jax):
        orig = getattr(mod, name)

        def put(k, x):
            seen.setdefault(k, []).append(np.array(x))

        def run(img, *a, **kw):
            out = orig(img, *a, **kw)
            for k, x in ((key + "_in", img), (key, out)):
                if on_jax:
                    jax.debug.callback(lambda v, k=k: put("j" + k, v), x)
                else:
                    put("t" + k, x.clone())
            return out
        setattr(mod, name, run)
    for jm, tm, name, key in ((jcol, tcol, "decode_color", "decode"),
                              (jcol, tcol, "linearize", "lin"),
                              (jpolar, tpolar, "sample_polar", "ewa")):
        wrap(jm, name, key, True)
        wrap(tm, name, key, False)
    jt = JTarget(w=2 * SRC_W, h=2 * SRC_H, color=jcs.CSP_SRGB, bit_depth=8)
    tt = lt.Target(w=2 * SRC_W, h=2 * SRC_H, color=lt.CSP_SRGB, bit_depth=8)
    jr, tr = JRenderer(), lt.Renderer(device="cpu")
    for i, (yuv, buf) in enumerate(zip(_yuv10(3), path_c_rpus(3))):
        ref = np.asarray(jr._render_once(_path_c_frame(jcs, yuv, buf), jt,
                                         JParams(upscaler="ewa_lanczos")))
        out = tr.render(_path_c_frame(tcs, yuv, buf, "cpu"), tt,
                        lt.RenderParams(upscaler="ewa_lanczos")).numpy()
        for key in ("decode_in", "decode", "lin", "ewa"):
            d = np.abs(seen["j" + key][i] - seen["t" + key][i])
            print(f"frame {i} {key:9s} differing {(d > 0).mean():.4f}, "
                  f"max {d.max():.3e}")
        d = np.abs(out.astype(np.float64) - ref)
        print(f"frame {i} output    differing {(d > 1e-6).mean():.2e}, "
              f"> 1 LSB {(d > LSB + 1e-6).mean():.2e}, max "
              f"{d.max() / LSB:.2f} LSB, PSNR "
              f"{10 * np.log10(1.0 / max((d ** 2).mean(), 1e-20)):.2f} dB")


if __name__ == "__main__":
    _measure()

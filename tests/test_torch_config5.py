"""PyTorch port, config 5: deband, AV1 film grain and error diffusion
(kernels K2 and K3) against the JAX package.

The JAX side runs jitted, as its renderer runs these stages: under jit
XLA fuses the one-use products of deband's grain add, the grain overlap
blends and the grain add into fused multiply-adds, and the port writes
the same roundings out (core/fastmath.fma).  Pallas kernels run in
interpret mode, as the JAX package's own tests run them.

Tolerances:
- the random tables (threefry), the grain tables, deband, grain, the
  shear (K3's plain version) and the wavefront (K2's plain version, and
  the whole error_diffusion dispatch): exact;
- the whole render, 2 chained frames: every 8-bit value within 1 LSB
  except on <= 5e-4 of them, PSNR >= 45 dB, and fewer than 12% of
  values differing.  Error diffusion is exact on identical input, and
  the same test shows it on these frames: the frame the JAX renderer
  hands to error diffusion, diffused by the port, gives exactly the
  JAX render's output.  So every difference enters with that encoded
  frame, slice 1's render.  Measured over a chain of 8 frames (run this
  module as a script, from the repository's root with it on
  PYTHONPATH): the encoded frame differs from the reference's on
  25.9-31.0% of its values, by more than 1e-5 on 2.1-2.9% of them, by
  at most 0.0124 (the witness gates < 5% and 4 LSB); the port's K1 run
  on the JAX renderer's K1 input lands within 2.4e-7 of its output, so
  the differences enter with the linear image the tail is given (the
  EWA sum's order, a decode product), which the tone and gamut mapping
  then magnify on some pixels of the random test content.  One changed
  input flips a rounding wherever cur * scale sits near a .5 tie, and
  the flipped error diffuses on: 7.0-8.9% of 8-bit values differ,
  <= 4.1e-5 of them by more than 1 LSB (at most 3), PSNR 58.6-59.7 dB.
  Peak state atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libplacebo_tpu.core import colorspace as jcs
from libplacebo_tpu.core import dither as jdither
from libplacebo_tpu.core import film_grain as jcfg
from libplacebo_tpu.ops import deband as jdeband
from libplacebo_tpu.ops import film_grain as jfg
from libplacebo_tpu.ops.dithering import error_diffusion_scan as jscan
from libplacebo_tpu.ops.pallas.error_diffusion import error_diffusion_pallas
from libplacebo_tpu.ops.pallas.shear import (shear_to_colmaj as jshear,
                                             unshear_from_colmaj as junshear)
from libplacebo_tpu.render.frame import frame_from_yuv420p as j_frame
from libplacebo_tpu.render.renderer import RenderParams as JParams
from libplacebo_tpu.render.renderer import Renderer as JRenderer
from libplacebo_tpu.render.renderer import Target as JTarget

import libplacebo_tpu_torch as lt
from libplacebo_tpu_torch import carry
from libplacebo_tpu_torch.core import dither as tdither
from libplacebo_tpu_torch.core import film_grain as tcfg
from libplacebo_tpu_torch.core import threefry
from libplacebo_tpu_torch.ops import deband as tdeband
from libplacebo_tpu_torch.ops import dithering as tdith
from libplacebo_tpu_torch.ops import film_grain as tfg
from libplacebo_tpu_torch.ops.cuda import error_diffusion as k2
from libplacebo_tpu_torch.ops.cuda import shear as k3

LSB = 1.0 / 255.0
SRC_H, SRC_W = 64, 128
ED_KERNELS = ["simple", "sierra-lite", "floyd-steinberg", "atkinson",
              "jarvis-judice-ninke"]
# the reference's grain description, made from the port's copy of it
J_GRAIN = jcfg.FilmGrainData(type="av1", seed=7391, av1=jcfg.AV1GrainData(
    **dataclasses.asdict(tcfg.sample_grain(7391).av1)))


def _grain(seed=7391):
    """The reference's grain description carried into the port."""
    return carry.film_grain_from_fields(
        dataclasses.asdict(dataclasses.replace(J_GRAIN, seed=seed)))


def test_grain_description_carries_and_matches_the_port_copy():
    """The port's copy of the reference's test grain
    (core/film_grain.sample_grain) holds the same integers as
    tests/test_film_grain.py::DATA, and carry.film_grain_from_fields
    rebuilds a reference description field for field."""
    from tests.test_film_grain import DATA
    assert dataclasses.asdict(J_GRAIN) == dataclasses.asdict(DATA)
    g = carry.film_grain_from_fields(dataclasses.asdict(DATA))
    assert g == tcfg.sample_grain(7391)
    assert dataclasses.asdict(g) == dataclasses.asdict(DATA)
    assert tfg.needs_fg(g) and tfg.needs_film_grain(g, (1,))


# -- random tables -------------------------------------------------------

@pytest.mark.parametrize("shape,seed", [
    ((1, 32, 64), 0), ((2, 37, 53), 1), ((1, 64, 128), 2),
    ((1, 540, 960), 1), ((1, 1080, 1920), 0)])
def test_threefry_tables_match_jax_random(shape, seed):
    """core/threefry.py equals jax.random bit for bit: deband's candidate
    choices (randint) and grain noise (uniform float32), at the shapes of
    the tests and of a 1080p frame's planes."""
    p = tdeband.DebandParams(iterations=2)
    jc, jn = jdeband.deband_rng_tables(jdeband.DebandParams(iterations=2),
                                       shape, seed)
    tc, tn = tdeband.deband_rng_tables(p, shape, seed)
    assert len(jc) == len(tc) == 2
    for a, b in zip(jc, tc):
        assert b.dtype == np.int32
        np.testing.assert_array_equal(np.asarray(a), b)
    assert tn.dtype == np.float32
    np.testing.assert_array_equal(np.asarray(jn).view(np.uint32),
                                  tn.view(np.uint32))


def test_threefry_split_and_odd_spans():
    """Keys through several splits, and randint over a span that is not
    a power of two (both 32-bit draws then count)."""
    jk, tk = jax.random.PRNGKey(7), threefry.PRNGKey(7)
    for _ in range(3):
        jk, jsub = jax.random.split(jk)
        tk, tsub = threefry.split(tk)
        np.testing.assert_array_equal(np.asarray(jk), tk)
        np.testing.assert_array_equal(
            np.asarray(jax.random.randint(jsub, (33, 17), 3, 10)),
            threefry.randint(tsub, (33, 17), 3, 10))


# -- host tables ---------------------------------------------------------

def test_host_tables_exact():
    """Deband's offset draws, and the grain LUT tile stacks, per-block
    offsets, scaling LUTs and chroma constants, bit for bit."""
    for seed in range(3):
        jp = jdeband.DebandParams(iterations=2)
        for (ja, jb), (ta, tb) in zip(
                jdeband._offset_draws(jp, seed),
                tdeband._offset_draws(tdeband.DebandParams(iterations=2),
                                      seed)):
            np.testing.assert_array_equal(ja, ta)
            np.testing.assert_array_equal(jb, tb)
    tg = _grain()
    for ch, sx, sy in ((0, 0, 0), (1, 1, 1), (2, 1, 1), (1, 1, 0)):
        for a, b in zip(jfg._tile_stacks_np(J_GRAIN.av1, 7391, ch, sx, sy, 8),
                        tfg._tile_stacks_np(tg.av1, 7391, ch, sx, sy, 8)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(jcfg.generate_offsets(7391, 60, 36),
                                  tcfg.generate_offsets(7391, 60, 36))
    for ch, sub in (((0,), 0), ((1,), 1), ((2,), 1)):
        jc = jfg.grain_cfg_for(J_GRAIN, ch, sub_x=sub, sub_y=sub)
        tc = tfg.grain_cfg_for(tg, ch, sub_x=sub, sub_y=sub)
        jt = jfg.prepare_av1_grain(J_GRAIN, jc, 64, 128)
        tt = tfg.prepare_av1_grain(tg, tc, 64, 128, "cpu")
        nby, nbx = tt.offsets.shape
        np.testing.assert_array_equal(np.asarray(jt.offsets)[:nby],
                                      tt.offsets.numpy())
        np.testing.assert_array_equal(np.asarray(jt.chans[0].scaling),
                                      tt.chans[0].scaling.numpy())
        np.testing.assert_array_equal(np.asarray(jt.chans[0].uv_consts),
                                      np.float32(tt.chans[0].uv_consts))


# -- deband and grain ----------------------------------------------------

@pytest.mark.parametrize("shape,seed,inject", [
    ((1, 64, 128), 0, False), ((1, 32, 64), 1, False),
    ((1, 64, 128), 2, True), ((2, 32, 64), 1, True)])
def test_deband_matches_jax(shape, seed, inject):
    """deband, 2 iterations with grain, on the same plane: exact, with
    the port's own tables or with JAX's injected (carry)."""
    rng = np.random.default_rng(seed)
    img = (rng.random(shape) * 0.6 + 0.2).astype(np.float32)
    ntr = (16 / 256 * 256 / 255, 0.5 * 256 / 255)[:shape[0]]
    jp = jdeband.DebandParams(iterations=2, grain=4.0 / (1000 / 203))
    tp = tdeband.DebandParams(iterations=2, grain=4.0 / (1000 / 203))
    ref = np.asarray(jax.jit(lambda x: jdeband.deband(
        x, jp, seed=seed, neutral=ntr))(jnp.asarray(img)))
    tables = None
    if inject:
        jc, jn = jdeband.deband_rng_tables(jp, shape, seed)
        tables = carry.deband_tables_from_numpy(
            [np.asarray(c) for c in jc], np.asarray(jn), device="cpu")
    out = tdeband.deband(torch.from_numpy(img), tp, seed=seed,
                         tables=tables, neutral=ntr).numpy()
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("plane", ["luma", "chroma420"])
def test_film_grain_matches_jax(plane):
    """apply_av1_grain with overlap on a luma plane and on a 4:2:0 chroma
    plane (scaled by the nearest-subsampled luma): exact."""
    H, W = 64, 128
    rng = np.random.default_rng(3)
    y = (rng.random((1, H, W)) * 0.8 + 0.06).astype(np.float32)
    uv = (rng.random((1, H // 2, W // 2)) * 0.8 + 0.06).astype(np.float32)
    ch, sub, data = ((0,), 0, y) if plane == "luma" else ((1,), 1, uv)
    h, w = data.shape[-2:]
    jc = jfg.grain_cfg_for(J_GRAIN, ch, 8, sub, sub)
    tc = tfg.grain_cfg_for(_grain(), ch, 8, sub, sub)
    jluma = tluma = None
    if sub:
        jluma = jfg.subsample_nearest(jnp.asarray(y[0]), 1, 1, h, w)
        tluma = tfg.subsample_nearest(torch.from_numpy(y[0]), 1, 1, h, w)
        np.testing.assert_array_equal(np.asarray(jluma), tluma.numpy())
    ref = jax.jit(jfg.apply_av1_grain, static_argnums=(2, 3))(
        jnp.asarray(data), jfg.prepare_av1_grain(J_GRAIN, jc, h, w), jc, 11,
        luma=jluma)
    out = tfg.apply_av1_grain(
        torch.from_numpy(data), tfg.prepare_av1_grain(_grain(), tc, h, w,
                                                      "cpu"),
        tc, 11, luma=tluma)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# -- K3 and K2: plain versions ------------------------------------------

@pytest.mark.parametrize("shape,s", [((3, 37, 53), 2), ((1, 130, 200), 1),
                                     ((2, 200, 131), 3)])
def test_shear_plain_matches_pallas(shape, s):
    """K3's plain version vs shear_to_colmaj / unshear_from_colmaj in
    interpret mode at the reference's padded widths: exact, float32
    forward, float32 and int16 back."""
    C, H, W = shape
    rng = np.random.default_rng(7)
    x = rng.random((C, H, W)).astype(np.float32)
    Ws = W + (H - 1) * s
    Wp, Hp, Wsp = [-(-v // 128) * 128 for v in (W, H, Ws)]
    xcm = np.pad(np.moveaxis(x, 2, 0), ((0, Wp - W), (0, 0), (0, Hp - H)))
    ref = np.asarray(jshear(jnp.asarray(xcm), Wsp, s, W, H, interpret=True))
    cm = k3.shear_to_colmaj(torch.from_numpy(xcm), Wsp, s, W, H)
    np.testing.assert_array_equal(cm.numpy(), ref)
    back = k3.unshear_from_colmaj(cm, Wp, s, W, H)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(junshear(jnp.asarray(ref), Wp, s, W, H,
                                          interpret=True)))
    np.testing.assert_array_equal(back.numpy(), xcm)
    codes = (cm * 255).to(torch.int16)
    np.testing.assert_array_equal(
        k3.unshear_from_colmaj(codes, Wp, s, W, H).numpy(),
        np.asarray(junshear(jnp.asarray(codes.numpy()), Wp, s, W, H,
                            interpret=True)))


@pytest.mark.parametrize("shape,s", [((3, 37, 53), 1), ((2, 33, 71), 2),
                                     ((3, 45, 29), 3), ((1, 31, 97), 5)])
def test_shear_chw_plain_matches_pallas(shape, s):
    """K3's plain version in the renderer's (C, H, W) layout vs
    shear_to_colmaj / unshear_from_colmaj in interpret mode, the JAX input
    moved to (W, C, H) and padded to the reference's widths: the sheared
    image is the reference's without its pad (which is zero), the
    unshear of float32 and of int16 codes the reference's moved back, and
    the scaled unshear its codes * (1/scale) clipped: exact."""
    C, H, W = shape
    rng = np.random.default_rng(17 + s)
    x = rng.random((C, H, W)).astype(np.float32)
    Ws = W + (H - 1) * s
    Wp, Hp, Wsp = [-(-v // 128) * 128 for v in (W, H, Ws)]
    xcm = np.pad(np.moveaxis(x, 2, 0), ((0, Wp - W), (0, 0), (0, Hp - H)))
    ref = np.asarray(jshear(jnp.asarray(xcm), Wsp, s, W, H, interpret=True))
    cm = k3.shear_chw(torch.from_numpy(x), s)
    assert cm.shape == (Ws, C, H) and cm.is_contiguous()
    np.testing.assert_array_equal(cm.numpy(), ref[:Ws, :, :H])
    assert not ref[Ws:].any() and not ref[:, :, H:].any()
    padded = np.pad(cm.numpy(), ((0, Wsp - Ws), (0, 0), (0, Hp - H)))
    back = k3.unshear_chw(cm, s, W)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(back.numpy(), np.moveaxis(np.asarray(
        junshear(jnp.asarray(padded), Wp, s, W, H, interpret=True))[
            :W, :, :H], 0, 2))
    codes = np.asarray(junshear(jnp.asarray((padded * 255).astype(np.int16)),
                                Wp, s, W, H, interpret=True))
    codes = np.moveaxis(codes[:W, :, :H], 0, 2)             # (C, H, W)
    t_codes = (cm * 255).to(torch.int16)
    assert t_codes.dtype == torch.int16
    np.testing.assert_array_equal(k3.unshear_chw(t_codes, s, W).numpy(),
                                  codes)
    inv = float(np.float32(1) / np.float32(255))
    np.testing.assert_array_equal(
        k3.unshear_chw(t_codes, s, W, inv).numpy(),
        np.clip(codes.astype(np.float32) * np.float32(inv), 0.0, 1.0))


@pytest.mark.parametrize("name", ED_KERNELS)
def test_wavefront_plain_matches_pallas_and_scan(name):
    """The port's error_diffusion (K3 -> K2 -> K3, plain versions) and its
    scan oracle vs error_diffusion_pallas(interpret=True) and
    error_diffusion_scan, 3 bits at (2, 48, 72): exact.  The Pallas
    kernel walks 4 columns a grid step here (its result does not depend
    on the chunking; tests/test_pallas_kernels.py pins the default), which
    compiles ~5x faster in interpret mode."""
    rng = np.random.default_rng(42)
    img = rng.random((2, 48, 72)).astype(np.float32)
    jk = jdither.find_error_diffusion_kernel(name)
    tk = tdither.find_error_diffusion_kernel(name)
    assert k2.taps_for(tk) == [
        (dy, dx + dy * jk.shift, float(w))
        for dy, row in enumerate(jk.normalized())
        for dx, w in zip(range(-2, 3), row) if w]
    pal = np.asarray(error_diffusion_pallas(jnp.asarray(img), 3, jk,
                                            interpret=True, cols_per_step=4))
    np.testing.assert_array_equal(np.asarray(jscan(jnp.asarray(img), 3, jk)),
                                  pal)
    x = torch.from_numpy(img)
    out = tdith.error_diffusion(x, 3, tk)
    assert out.is_contiguous()
    np.testing.assert_array_equal(out.numpy(), pal)
    np.testing.assert_array_equal(
        tdith.error_diffusion_scan(x, 3, tk).numpy(), pal)


@pytest.mark.parametrize("case", ["batched", "strided"])
def test_error_diffusion_returns_contiguous(case):
    """error_diffusion (K3 (C, H, W) -> K2 -> K3 back, plain versions)
    returns a contiguous (..., C, H, W) frame equal to the port's and the
    JAX package's error_diffusion_scan: a batch of 2 frames of 2 channels,
    and a strided view (every other column of a wider frame)."""
    rng = np.random.default_rng(44)
    if case == "batched":
        img = rng.random((2, 2, 24, 40)).astype(np.float32)
        x = torch.from_numpy(img)
    else:
        wide = rng.random((3, 24, 80)).astype(np.float32)
        img = np.ascontiguousarray(wide[:, :, ::2])
        x = torch.from_numpy(wide)[:, :, ::2]
        assert not x.is_contiguous()
    k = tdither.find_error_diffusion_kernel("sierra-lite")
    out = tdith.error_diffusion(x, 4, k)
    assert out.shape == x.shape and out.is_contiguous()
    np.testing.assert_array_equal(out.numpy(),
                                  tdith.error_diffusion_scan(x, 4, k).numpy())
    np.testing.assert_array_equal(out.numpy(), np.asarray(jscan(
        jnp.asarray(img), 4, jdither.find_error_diffusion_kernel(
            "sierra-lite"))))


def test_wavefront_rounds_the_error_once():
    """On input that sits on quantization ties the error's rounding shows:
    the reference computes cur - r/scale as one fused multiply-add.  8-bit
    Floyd-Steinberg at (1, 128, 256): exact."""
    rng = np.random.default_rng(1)
    img = (np.round(rng.random((1, 128, 256)) * 1020) / 1020).astype(
        np.float32)
    ref = np.asarray(error_diffusion_pallas(
        jnp.asarray(img), 8, jdither.ED_FLOYD_STEINBERG, interpret=True,
        cols_per_step=4))
    out = tdith.error_diffusion(torch.from_numpy(img), 8,
                                tdither.ED_FLOYD_STEINBERG)
    np.testing.assert_array_equal(out.numpy(), ref)


def _compiled_tap_tables(text=None, n=None):
    """{pattern index: (name, shift, taps)} as K2 is compiled with them:
    the `pattern()` switch of the header `tap_table_header` generates
    for csrc/error_diffusion.cu (by default the built-in library's), read
    back from its C++ text (name None where the header has none)."""
    import re
    if text is None:
        text, n = k2.tap_table_header(), len(tdither.ERROR_DIFFUSION_KERNELS)
    assert f"constexpr int kPatterns = {n};" in text
    tables = {}
    for m in re.finditer(
            r"case (\d+):\s*(?://\s*([\w-]+))?\s*return\s*\{(.*?)\};",
            text, re.S):
        head, dys, offs, wgts = re.fullmatch(
            r"(\d+,\s*\d+),\s*\{(.*?)\},\s*\{(.*?)\},\s*\{(.*?)\}",
            m.group(3).strip(), re.S).groups()
        shift, n = (int(v) for v in head.split(","))
        dys, offs = ([int(v) for v in g.split(",")] for g in (dys, offs))
        wgts = [float.fromhex(v.strip().rstrip("f")) for v in wgts.split(",")]
        assert len(dys) == len(offs) == len(wgts) == n
        tables[int(m.group(1))] = (m.group(2), shift, list(zip(dys, offs,
                                                               wgts)))
    return tables


@pytest.mark.parametrize("index", range(len(tdither.ERROR_DIFFUSION_KERNELS)))
def test_k2_compiled_tap_table_equals_taps_for(index):
    """The tap table compiled into K2 (one template instance a pattern,
    from the generated header) is, pattern for pattern in
    ERROR_DIFFUSION_KERNELS order, the pattern's shift and taps_for(k):
    the same taps, order and float32 weights, bit for bit."""
    tables = _compiled_tap_tables()
    assert sorted(tables) == list(range(len(tdither.ERROR_DIFFUSION_KERNELS)))
    k = tdither.ERROR_DIFFUSION_KERNELS[index]
    name, shift, taps = tables[index]
    assert (name, shift) == (k.name, k.shift)
    want = k2.taps_for(k)
    assert [(dy, off) for dy, off, _ in taps] == \
        [(dy, off) for dy, off, _ in want]
    assert np.array_equal(np.float32([w for _, _, w in taps]).view(np.uint32),
                          np.float32([w for _, _, w in want]).view(np.uint32))


# patterns outside ERROR_DIFFUSION_KERNELS: (name, shift, pattern,
# divisor); "reach-16" reaches sheared offset 16, "too-far" 18 and
# "shift-16" 34 (each compiled into a K2 library of its own on the card)
CUSTOM_PATTERNS = [
    ("custom-3row", 2, ((0, 0, 0, 5, 2), (0, 3, 4, 1, 0), (0, 0, 1, 0, 0)),
     16),
    ("custom-wide", 3, ((0, 0, 0, 6, 3), (2, 3, 5, 3, 1), (1, 2, 3, 2, 1)),
     32),
    ("reach-16", 7, ((0, 0, 0, 2, 1), (0, 0, 1, 0, 0), (0, 0, 0, 0, 1)), 5),
    ("too-far", 8, ((0, 0, 0, 1, 0), (0, 0, 0, 0, 0), (0, 0, 0, 0, 1)), 2),
    ("shift-16", 16, ((0, 0, 0, 4, 1), (1, 2, 3, 2, 1), (0, 1, 1, 1, 1)),
     18),
]


def _custom(mod, case):
    name, shift, pattern, divisor = case
    return mod.ErrorDiffusionKernel(name, name, shift, pattern, divisor)


@pytest.mark.parametrize("case", CUSTOM_PATTERNS, ids=lambda c: c[0])
def test_custom_pattern_matches_scan(case):
    """A pattern outside ERROR_DIFFUSION_KERNELS through the port's
    error_diffusion (K3 -> K2 -> K3, plain versions) vs the JAX
    error_diffusion_scan, 3 bits at (2, 40, 56): exact."""
    img = np.random.default_rng(43).random((2, 40, 56)).astype(np.float32)
    ref = np.asarray(jscan(jnp.asarray(img), 3, _custom(jdither, case)))
    out = tdith.error_diffusion(torch.from_numpy(img), 3,
                                _custom(tdither, case))
    np.testing.assert_array_equal(out.numpy(), ref)


def _renamed_fs(mod):
    fs = mod.ED_FLOYD_STEINBERG
    return mod.ErrorDiffusionKernel("my-fs", "a renamed copy", fs.shift,
                                    fs.pattern, fs.divisor)


@pytest.mark.parametrize("case", CUSTOM_PATTERNS + ["renamed-fs"],
                         ids=lambda c: c if isinstance(c, str) else c[0])
def test_k2_pattern_header_and_key(case):
    """A pattern outside ERROR_DIFFUSION_KERNELS is compiled from a header
    of its own: read back, the shift and the taps of taps_for in its
    order, float32 weights bit for bit, under no name, the library named
    by the header's hash.  The key is the shift and taps, not the name: a
    renamed copy of Floyd-Steinberg has Floyd-Steinberg's key and runs
    its instance of the built-in library."""
    if case == "renamed-fs":
        k = _renamed_fs(tdither)
        fs = tdither.ED_FLOYD_STEINBERG
        assert k != fs and k2.pattern_key(k) == k2.pattern_key(fs)
        header, index = k2._header_of(k)
        assert header is None and \
            tdither.ERROR_DIFFUSION_KERNELS[index] is fs
        assert k2.library_name(header) == "k2_error_diffusion"
        return
    k = _custom(tdither, case)
    header, index = k2._header_of(k)
    assert index == 0 and k.name not in header
    tables = _compiled_tap_tables(header, 1)
    assert list(tables) == [0]
    _, shift, taps = tables[0]
    assert shift == k.shift
    want = k2.taps_for(k)
    assert [(dy, off) for dy, off, _ in taps] == \
        [(dy, off) for dy, off, _ in want]
    assert np.array_equal(np.float32([w for _, _, w in taps]).view(np.uint32),
                          np.float32([w for _, _, w in want]).view(np.uint32))
    assert k2.pattern_key(k) == (k.shift,) + tuple(
        (dy, off, int(np.float32(w).view(np.uint32))) for dy, off, w in want)
    renamed = tdither.ErrorDiffusionKernel("other", "", k.shift, k.pattern,
                                           k.divisor)
    assert k2._header_of(renamed) == (header, 0)
    name = k2.library_name(header)
    assert name.startswith("k2_error_diffusion_p") and \
        name != k2.library_name()


def test_k2_prepare_failure_raises_kernel_error(monkeypatch):
    """A custom pattern's library that cannot be built raises KernelError
    from prepare (the renderer's call when it plans the frame), and the
    pattern is not cached as built: nothing would run in the kernel's
    place on the card.  The CPU entry runs the plain version regardless
    of the library."""
    from libplacebo_tpu_torch import _build

    def broken(name, *a):
        raise _build.KernelError(f"build of {name} failed (synthetic)")
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build, "load_shared", broken)
    k = tdither.ErrorDiffusionKernel(
        "unbuilt", "", 5, ((0, 0, 0, 3, 1), (1, 1, 2, 1, 0),
                           (0, 0, 1, 0, 1)), 11)
    for _ in range(2):
        with pytest.raises(_build.KernelError, match="k2_error_diffusion_p"):
            k2.prepare(k)
    x = torch.rand((2, 9, 13), generator=torch.Generator().manual_seed(3))
    cm = k3.shear_chw(x, k.shift)
    assert torch.equal(k2.wavefront(cm, k, 4, 13, 9),
                       k2.wavefront_plain(cm, k, 4, 13, 9))


@pytest.mark.parametrize("name", ["jarvis-judice-ninke", "no-such-pattern"])
def test_renderer_diffuses_with_its_named_pattern(monkeypatch, name):
    """RenderParams.error_diffusion names the pattern (an unknown name
    diffuses with Floyd-Steinberg, as in the reference): the renderer
    diffuses the encoded frame with it, exact against the JAX
    error_diffusion_scan with that pattern.  On the CPU it builds no K2
    library (it prepares one only on the card)."""
    seen = []
    orig = tdith.error_diffusion

    def capture(img, depth, kernel):
        seen.append((img.clone(), depth, kernel))
        return orig(img, depth, kernel)

    def no_build(kernel):
        raise AssertionError("K2 prepared on the CPU")
    monkeypatch.setattr(tdith, "error_diffusion", capture)
    monkeypatch.setattr(k2, "prepare", no_build)
    yuv = _yuv(5, 32, 48)
    target = lt.Target(w=96, h=64, color=lt.CSP_SRGB, bit_depth=8)
    out = lt.Renderer(device="cpu").render(
        _port_frame(*yuv, None), target,
        lt.RenderParams(error_diffusion=name)).numpy()
    (img, depth, kernel), = seen
    assert kernel is tdither.find_error_diffusion_kernel(name) and depth == 8
    jk = jdither.find_error_diffusion_kernel(name) or \
        jdither.ED_FLOYD_STEINBERG
    np.testing.assert_array_equal(
        out, np.asarray(jscan(jnp.asarray(img.numpy()), 8, jk)))


def _yuv(seed, h=SRC_H, w=SRC_W):
    rng = np.random.default_rng(seed)
    return ((rng.random((h, w)) * 219 + 16).astype(np.uint8),
            (rng.random((h // 2, w // 2)) * 224 + 16).astype(np.uint8),
            (rng.random((h // 2, w // 2)) * 224 + 16).astype(np.uint8))


def _port_frame(y, u, v, grain, device="cpu"):
    f = lt.frame_from_yuv420p(
        y, u, v, color=lt.CSP_BT2100_PQ, device=device,
        repr=lt.ColorRepr(sys=lt.ColorSystem.BT_2020_NC,
                          levels=lt.ColorLevels.LIMITED,
                          bits=lt.BitEncoding(8, 8, 0)))
    f.film_grain = grain
    return f


_T_PARAMS = lt.RenderParams(upscaler="ewa_lanczos",
                            deband=lt.DebandParams(iterations=2),
                            film_grain=True,
                            error_diffusion="floyd-steinberg")
_T_TARGET = lt.Target(w=2 * SRC_W, h=2 * SRC_H, color=lt.CSP_SRGB,
                      bit_depth=8)


def test_config5_render_two_frames(monkeypatch):
    """Config 5 end to end: 2 chained frames 64x128 -> 128x256 with the
    grain seed varied per frame, port on the CPU vs the JAX Renderer's
    fused path (gate in the module docstring).  The witness beside it:
    the frame each renderer hands to error diffusion is captured, and
    the JAX package's, diffused by the port, gives exactly the JAX
    render's output."""
    import libplacebo_tpu.ops.dithering as jdith
    monkeypatch.setenv("LPTPU_FUSED_COLORMAP", "1")
    seen = {"jax": [], "port": []}
    j_orig, t_orig = jdith.error_diffusion, tdith.error_diffusion

    def j_capture(img, depth, kernel):
        jax.debug.callback(lambda x: seen["jax"].append(np.array(x)), img)
        return j_orig(img, depth, kernel)

    def t_capture(img, depth, kernel):
        seen["port"].append(img.clone())
        return t_orig(img, depth, kernel)
    monkeypatch.setattr(jdith, "error_diffusion", j_capture)
    monkeypatch.setattr(tdith, "error_diffusion", t_capture)
    jp = JParams(upscaler="ewa_lanczos",
                 deband=jdeband.DebandParams(iterations=2), film_grain=True,
                 error_diffusion="floyd-steinberg")
    jt = JTarget(w=2 * SRC_W, h=2 * SRC_H, color=jcs.CSP_SRGB, bit_depth=8)
    jr, tr = JRenderer(), lt.Renderer(device="cpu")
    fs = tdither.find_error_diffusion_kernel("floyd-steinberg")
    for i in range(2):
        yuv = _yuv(3 + i)
        jf = j_frame(*yuv, color=jcs.CSP_BT2100_PQ, repr=jcs.ColorRepr(
            sys=jcs.ColorSystem.BT_2020_NC, levels=jcs.ColorLevels.LIMITED,
            bits=jcs.BitEncoding(8, 8, 0)))
        jf.film_grain = dataclasses.replace(J_GRAIN, seed=7391 + i)
        ref = np.asarray(jr._render_once(jf, jt, jp))
        out = tr.render(_port_frame(*yuv, _grain(7391 + i)), _T_TARGET,
                        _T_PARAMS).numpy()
        # the witness: on the JAX renderer's own input the port's error
        # diffusion gives exactly the JAX render's output (its error
        # diffusion of that input, which the final clamp leaves as it
        # is), so every difference gated below enters with the encoded
        # frame
        j_in, t_in = seen["jax"][i], seen["port"][i].numpy()
        port_on_j = t_orig(torch.from_numpy(j_in), 8, fs).numpy()
        assert port_on_j.min() >= 0.0 and port_on_j.max() <= 1.0
        np.testing.assert_array_equal(port_on_j, ref)
        d_in = np.abs(t_in - j_in)
        assert (d_in > 1e-5).mean() < 0.05 and d_in.max() <= 4 * LSB
        assert out.shape == ref.shape == (3, 2 * SRC_H, 2 * SRC_W)
        np.testing.assert_allclose(out * 255, np.round(out * 255),
                                   atol=1e-3)
        diff = np.abs(out - ref)
        assert (diff > LSB + 1e-6).mean() <= 5e-4
        assert (diff > 1e-6).mean() < 0.12
        assert 10 * np.log10(1.0 / max((diff ** 2).mean(), 1e-12)) >= 45
        np.testing.assert_allclose(tr._peak_state.numpy(),
                                   np.asarray(jr._peak_state), atol=1e-5)


def test_film_grain_switch():
    """RenderParams.film_grain=False renders a grain-carrying frame as if
    it carried none; with it on (the default), the grain shows."""
    yuv = _yuv(9, 16, 128)
    target = lt.Target(w=256, h=32, color=lt.CSP_SRGB, bit_depth=8)
    params = lt.RenderParams(upscaler="ewa_lanczos")
    bare = lt.Renderer(device="cpu").render(_port_frame(*yuv, None), target,
                                            params)
    off = lt.Renderer(device="cpu").render(
        _port_frame(*yuv, _grain()), target,
        dataclasses.replace(params, film_grain=False))
    on = lt.Renderer(device="cpu").render(_port_frame(*yuv, _grain()),
                                          target, params)
    assert torch.equal(bare, off)
    assert not torch.equal(bare, on)


# -- the kernels on the card ---------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,s", [((3, 37, 53), 2), ((3, 130, 200), 3),
                                     ((3, 70, 41), 9), ((2, 40, 33), 16)])
def test_k3_kernel_matches_plain_on_card(cuda_device, shape, s):
    """K3 both ways in the reference's (W, C, H) layout vs its plain
    version on the card: exact, the inverse also into a padded width
    (the kernel writes the pad's zeros); s = 9 and 16 take its body's
    > 48 KB shared-memory path."""
    C, H, W = shape
    x = torch.rand((W, C, H), device=cuda_device)
    Ws = W + (H - 1) * s
    before = k3.launches
    cm = k3.shear_to_colmaj(x, Ws + 5, s, W, H)
    torch.testing.assert_close(cm, k3.shear_plain(x, Ws + 5, s, W, H, True),
                               rtol=0, atol=0)
    codes = (cm * 255).to(torch.int16)
    back = k3.unshear_from_colmaj(codes, W, s, W, H)
    assert torch.equal(back, k3.shear_plain(codes, W, s, W, H, False))
    padded = k3.unshear_from_colmaj(codes, W + 3, s, W, H)
    assert torch.equal(padded, k3.shear_plain(codes, W + 3, s, W, H, False))
    assert k3.launches == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("shape,s", [((3, 37, 53), 1), ((3, 130, 200), 2),
                                     ((2, 45, 29), 3), ((1, 31, 97), 5),
                                     ((3, 70, 41), 9), ((2, 40, 33), 16),
                                     ((3, 1080, 1920), 2)])
def test_k3_chw_kernel_matches_plain_on_card(cuda_device, shape, s):
    """K3 in the renderer's (C, H, W) layout vs its plain versions on the
    card: the shear of a contiguous frame and of a strided view, the
    unshear of int16 and int32 codes, and the scaled unshear into
    float32: exact, each launch counted."""
    C, H, W = shape
    gen = torch.Generator(device=cuda_device).manual_seed(H + s)
    x = torch.rand((C, H, W), device=cuda_device, generator=gen)
    before = k3.launches
    cm = k3.shear_chw(x, s)
    assert torch.equal(cm, k3.shear_chw_plain(x, s))
    wide = torch.rand((C, H, 2 * W), device=cuda_device, generator=gen)
    assert torch.equal(k3.shear_chw(wide[:, :, 1::2], s),
                       k3.shear_chw_plain(wide[:, :, 1::2], s))
    inv = float(np.float32(1) / np.float32(255))
    for dt in (torch.int16, torch.int32):
        codes = (cm * 255).round().to(dt)
        back = k3.unshear_chw(codes, s, W)
        assert back.dtype == dt and back.is_contiguous()
        assert torch.equal(back, k3.unshear_chw_plain(codes, s, W))
        scaled = k3.unshear_chw(codes, s, W, inv)
        assert scaled.dtype == torch.float32 and scaled.is_contiguous()
        assert torch.equal(scaled, k3.unshear_chw_plain(codes, s, W, inv))
    torch.cuda.synchronize()
    assert k3.launches == before + 6


@pytest.mark.cuda
@pytest.mark.parametrize("name", ED_KERNELS + ["stucki", "sierra-3"])
def test_k2_kernel_matches_plain_on_card(cuda_device, name):
    """K2 vs its plain version on the same sheared input: exact codes."""
    k = tdither.find_error_diffusion_kernel(name)
    C, H, W = 3, 96, 160
    x = torch.rand((C, H, W), device=cuda_device)
    Ws = W + (H - 1) * k.shift
    cm = k3.shear_plain(x.permute(2, 0, 1).contiguous(), Ws, k.shift, W, H,
                        True)
    before = k2.launches
    out = k2.wavefront(cm, k, 8, W, H)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    assert torch.equal(out, k2.wavefront_plain(cm, k, 8, W, H))


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("name", [k.name for k in
                                  tdither.ERROR_DIFFUSION_KERNELS])
@pytest.mark.parametrize("shape", [(3, 37, 5), (2, 300, 3), (3, 70, 41)])
def test_k2_kernel_crosses_band_boundaries_on_card(cuda_device, shape,
                                                   name, depth):
    """K2 vs its plain version where the pipelining can go wrong: row
    counts that are not a multiple of the 32-row band (one lane a row),
    several bands and blocks (boundary errors handed down through the
    global buffer), narrow images (W < s*H, most of the sheared frame
    outside the image), at 8 bits (int16 codes) and 16 (int32).  Every
    sheared position is written: the whole code array is exact."""
    _k2_exact_on_card(cuda_device, shape, name, depth)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("name", ["floyd-steinberg", "jarvis-judice-ninke"])
def test_k2_kernel_beyond_8192_rows_on_card(cuda_device, name, depth):
    """More rows than the earlier one-block-a-channel kernel took (8192):
    258 bands of a 2-column image, exact (the plain version walks its
    16-25 thousand sheared columns in a few seconds)."""
    _k2_exact_on_card(cuda_device, (1, 8250, 2), name, depth)


def _k2_exact_on_card(cuda_device, shape, name, depth):
    k = tdither.find_error_diffusion_kernel(name)
    C, H, W = shape
    gen = torch.Generator(device=cuda_device).manual_seed(H * 7 + W)
    x = torch.rand((C, H, W), device=cuda_device, generator=gen)
    Ws = W + (H - 1) * k.shift
    cm = k3.shear_plain(x.permute(2, 0, 1).contiguous(), Ws, k.shift, W, H,
                        True)
    out = k2.wavefront(cm, k, depth, W, H)
    torch.cuda.synchronize()
    assert out.dtype == (torch.int16 if depth == 8 else torch.int32)
    assert torch.equal(out, k2.wavefront_plain(cm, k, depth, W, H))


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("case", CUSTOM_PATTERNS, ids=lambda c: c[0])
@pytest.mark.parametrize("shape", [(3, 70, 41), (2, 96, 160)])
def test_k2_custom_pattern_on_card(cuda_device, shape, case, depth):
    """A pattern outside ERROR_DIFFUSION_KERNELS runs on its own compiled
    K2 instance (a library built from its header, its window its own
    largest offset, up to 34 for shift-16): exact against the plain
    version, across band boundaries, at 8 and 16 bits."""
    k = _custom(tdither, case)
    lib, index = k2.prepare(k)
    assert index == 0 and \
        lib.k2_max_window() == max(off for _, off, _ in k2.taps_for(k))
    C, H, W = shape
    x = torch.rand((C, H, W), device=cuda_device,
                   generator=torch.Generator(device=cuda_device).manual_seed(
                       H + W))
    Ws = W + (H - 1) * k.shift
    cm = k3.shear_plain(x.permute(2, 0, 1).contiguous(), Ws, k.shift, W, H,
                        True)
    before = k2.launches
    out = k2.wavefront(cm, k, depth, W, H)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    assert torch.equal(out, k2.wavefront_plain(cm, k, depth, W, H))


# patterns whose windows do not fit in registers: (name, shift, pattern,
# divisor); "ring-24" keeps its 50-column window in shared memory (a ring
# of 64 slots), "ring-300" its 602 columns in 128 KB of dynamic shared
# memory, "ring-520" its 1042 columns in the scratch
LONG_PATTERNS = [
    (f"ring-{shift}", shift, ((0, 0, 0, 3, 1), (1, 2, 3, 2, 1),
                              (0, 1, 1, 1, 1)), 17)
    for shift in (24, 300, 520)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", LONG_PATTERNS + ["renamed-fs"],
                         ids=lambda c: c if isinstance(c, str) else c[0])
def test_k2_long_window_and_renamed_pattern_on_card(cuda_device, case):
    """Patterns with windows beyond the registers (a ring in shared
    memory, then in the scratch) and a renamed copy of Floyd-Steinberg
    (the built-in library's instance): exact against the plain version
    over two bands of three channels."""
    k = _renamed_fs(tdither) if case == "renamed-fs" else \
        _custom(tdither, case)
    C, H, W = 3, 35, 30
    x = torch.rand((C, H, W), device=cuda_device,
                   generator=torch.Generator(device=cuda_device).manual_seed(
                       k.shift))
    cm = k3.shear_chw_plain(x, k.shift)
    lib, index = k2.prepare(k)
    if case == "renamed-fs":
        assert (lib, index) == k2.prepare(tdither.ED_FLOYD_STEINBERG)
    out = k2.wavefront(cm, k, 8, W, H)
    torch.cuda.synchronize()
    assert torch.equal(out, k2.wavefront_plain(cm, k, 8, W, H))


def _measure(n_frames=8):
    """Print the figures behind the end-to-end gate: per frame of a chain
    of `n_frames` config-5 frames (64x128 -> 128x256, a new input seed and
    grain seed each frame), the share of 8-bit values that differ from
    the JAX package's, the share above 1 LSB, the largest difference in
    LSB and the PSNR; then, for the frame each renderer hands to error
    diffusion, the share of values that differ, the share by more than
    1e-5 and the largest difference, and how far the port's K1 (plain
    version) run on the JAX renderer's K1 input lands from the JAX one's
    output."""
    import os
    import libplacebo_tpu.ops.dithering as jdith
    import libplacebo_tpu.ops.pallas.color_map as jcm
    from libplacebo_tpu_torch.ops.cuda import color_map as k1
    os.environ["LPTPU_FUSED_COLORMAP"] = "1"
    seen = {"jed": [], "jk1": [], "ted": [], "tk1": []}

    def capture(mod, name, key, on_jax):
        orig = getattr(mod, name)

        def run(img, *args, **kw):
            if on_jax:
                jax.debug.callback(
                    lambda x: seen[key].append(np.array(x)), img)
            else:
                seen[key].append((img.clone(), args))
            return orig(img, *args, **kw)
        setattr(mod, name, run)
    capture(jdith, "error_diffusion", "jed", True)
    capture(jcm, "fused_pointwise", "jk1", True)
    capture(tdith, "error_diffusion", "ted", False)
    capture(k1, "color_map_tail", "tk1", False)
    jp = JParams(upscaler="ewa_lanczos",
                 deband=jdeband.DebandParams(iterations=2), film_grain=True,
                 error_diffusion="floyd-steinberg")
    jt = JTarget(w=2 * SRC_W, h=2 * SRC_H, color=jcs.CSP_SRGB, bit_depth=8)
    jr, tr = JRenderer(), lt.Renderer(device="cpu")
    for i in range(n_frames):
        yuv = _yuv(3 + i)
        jf = j_frame(*yuv, color=jcs.CSP_BT2100_PQ,
                     repr=jcs.ColorRepr(sys=jcs.ColorSystem.BT_2020_NC,
                                        levels=jcs.ColorLevels.LIMITED,
                                        bits=jcs.BitEncoding(8, 8, 0)))
        jf.film_grain = dataclasses.replace(J_GRAIN, seed=7391 + i)
        ref = np.asarray(jr._render_once(jf, jt, jp))
        out = tr.render(_port_frame(*yuv, _grain(7391 + i)), _T_TARGET,
                        _T_PARAMS).numpy()
        diff = np.abs(out - ref)
        psnr = 10 * np.log10(1.0 / max((diff ** 2).mean(), 1e-12))
        print(f"frame {i}: differing {(diff > 1e-6).mean():.4f}, "
              f"> 1 LSB {(diff > LSB + 1e-6).mean():.2e}, max "
              f"{diff.max() / LSB:.2f} LSB, PSNR {psnr:.1f} dB")
        j_in, t_in = seen["jed"][i], seen["ted"][i][0].numpy()
        d_in = np.abs(t_in - j_in)
        plan, spline, lut = seen["tk1"][i][1]
        tail, _ = k1.tail_plain(torch.from_numpy(seen["jk1"][i]), plan,
                                spline, lut)
        print(f"  encoded frame: differing {(d_in > 0).mean():.4f}, "
              f"> 1e-5 {(d_in > 1e-5).mean():.4f}, max {d_in.max():.2e}; "
              f"port K1 on the JAX K1 input: max "
              f"{np.abs(tail.numpy() - j_in).max():.2e}")


def _bisect(n_frames=3):
    """Print where the encoded frame's divergence enters (ROADMAP §3,
    F1): per frame, the port against the JAX renderer at the input of
    decode (deband, grain and chroma merge done), after decode, after
    the PQ linearize, after the EWA and at the input of error diffusion
    (the encoded frame); then the stages alone on the JAX stage's input;
    then the encoded frame again with the JAX decode, and with the JAX
    decode and EWA outputs, fed into the port's render."""
    import os
    import libplacebo_tpu.ops.color as jcol
    import libplacebo_tpu.ops.dithering as jdith
    import libplacebo_tpu.ops.polar as jpol
    import libplacebo_tpu_torch.ops.color as tcol
    import libplacebo_tpu_torch.ops.polar as tpol
    from libplacebo_tpu_torch.core import colorspace as tcs
    from libplacebo_tpu_torch.core import filters as tflt
    from libplacebo_tpu_torch.core.common import RectF as TRectF
    os.environ["LPTPU_FUSED_COLORMAP"] = "1"
    seen = {}
    stages = ((jcol, tcol, "decode_color", "decode"),
              (jcol, tcol, "linearize", "lin"),
              (jpol, tpol, "sample_polar", "ewa"),
              (jdith, tdith, "error_diffusion", "enc"))
    originals = {}

    def wrap(mod, name, key, on_jax):
        orig = originals[(mod, name)] = getattr(mod, name)

        def put(k, x):
            seen.setdefault(k, []).append(np.array(x))

        def run(img, *args, **kw):
            out = orig(img, *args, **kw)
            for k, x in ((f"{key}_in", img), (key, out)):
                if on_jax:
                    jax.debug.callback(lambda v, k=k: put("j" + k, v), x)
                else:
                    put("t" + k, x.clone())
            return out
        setattr(mod, name, run)
    for jm, tm, name, key in stages:
        wrap(jm, name, key, True)
        wrap(tm, name, key, False)

    def report(label, a, b):
        d = np.abs(a - b)
        rel = d / np.maximum(np.abs(a), 1e-30)
        print(f"{label:32s} differing {(d > 0).mean():.4f}, > 1e-5 "
              f"{(d > 1e-5).mean():.4f}, max {d.max():.3e}, max relative "
              f"{rel.max():.2e}")

    jp = JParams(upscaler="ewa_lanczos",
                 deband=jdeband.DebandParams(iterations=2), film_grain=True,
                 error_diffusion="floyd-steinberg")
    jt = JTarget(w=2 * SRC_W, h=2 * SRC_H, color=jcs.CSP_SRGB, bit_depth=8)
    jr, tr = JRenderer(), lt.Renderer(device="cpu")
    for i in range(n_frames):
        yuv = _yuv(3 + i)
        jf = j_frame(*yuv, color=jcs.CSP_BT2100_PQ,
                     repr=jcs.ColorRepr(sys=jcs.ColorSystem.BT_2020_NC,
                                        levels=jcs.ColorLevels.LIMITED,
                                        bits=jcs.BitEncoding(8, 8, 0)))
        jf.film_grain = dataclasses.replace(J_GRAIN, seed=7391 + i)
        np.asarray(jr._render_once(jf, jt, jp))
        tr.render(_port_frame(*yuv, _grain(7391 + i)), _T_TARGET, _T_PARAMS)
        for key in ("decode_in", "decode", "lin", "ewa", "enc_in"):
            report(f"frame {i} {key}", seen["j" + key][i], seen["t" + key][i])
    for (mod, name), orig in originals.items():
        setattr(mod, name, orig)
    H, W = seen["jdecode"][0].shape[-2:]
    for i in range(n_frames):
        lin = tcol.linearize(torch.from_numpy(seen["jdecode"][i]),
                             tcs.CSP_BT2100_PQ).numpy()
        report(f"frame {i} linearize alone", seen["jlin"][i], lin)
        ewa = tpol.sample_polar(torch.from_numpy(seen["jlin"][i]),
                                tflt.find_filter_config("ewa_lanczos"),
                                2 * H, 2 * W, TRectF(0, 0, W, H)).numpy()
        report(f"frame {i} EWA alone", seen["jewa"][i], ewa)
    # the port's render with the JAX stage outputs fed in
    for fed in (("decode",), ("decode", "ewa")):
        frame = {"i": 0}
        saved = (tcol.decode_color, tpol.sample_polar)
        if "decode" in fed:
            tcol.decode_color = lambda img, repr: torch.from_numpy(
                seen["jdecode"][frame["i"]])
        if "ewa" in fed:
            tpol.sample_polar = lambda img, *a, **kw: torch.from_numpy(
                seen["jewa"][frame["i"]])
        wrap(tdith, "error_diffusion", "fed", False)
        fr = lt.Renderer(device="cpu")
        try:
            for i in range(n_frames):
                frame["i"] = i
                fr.render(_port_frame(*_yuv(3 + i), _grain(7391 + i)),
                          _T_TARGET, _T_PARAMS)
                report(f"frame {i} encoded, {'+'.join(fed)} fed",
                       seen["jenc_in"][i], seen["tfed_in"][-1])
        finally:
            tcol.decode_color, tpol.sample_polar = saved
            tdith.error_diffusion = originals[(tdith, "error_diffusion")]


if __name__ == "__main__":
    import sys
    _bisect() if sys.argv[1:] == ["bisect"] else _measure()


"""PyTorch port: the player's loop end to end against the JAX package on
the CPU, at 64x128 -> 128x256 — path G (a 23.976 fps HDR film on a 60
Hz display: the user's option string, lazily mapped source frames in the
frame queue, a queue update and render_image_mix a vsync, telemetry on)
and path H (config 5 with user hooks: a luma doubler and an
auto-exposure carrying state across frames).

Tolerances: path G's queue emissions (frame pts and signatures,
timestamps, vsync_duration) exactly, the mixed 8-bit frames within path
E's gate (tests/test_torch_mix.py: fewer than 1.2e-3 of the values
differing, more than 1 LSB on at most 1e-4 — K1's perceptual tail
magnifies F1's last-ulp EWA differences on knife-edge pixels), the peak
state atol 1e-5; path H's frames within config 5's gate
(tests/test_torch_config5.py: more than 1 LSB on at most 5e-4, fewer
than 12% differing, PSNR >= 45 dB — error diffusion turns ulp
differences upstream into 1-LSB flips), its carried hook state within
1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from libplacebo_tpu.core import colorspace as jcs
from libplacebo_tpu.core import film_grain as jcfg
from libplacebo_tpu.ops import deband as jdeband
from libplacebo_tpu.render import frame as jfr
from libplacebo_tpu.render import hooks as jhooks
from libplacebo_tpu.render import queue as jq
from libplacebo_tpu.render import renderer as jr

import chip_smoke
import libplacebo_tpu_torch as lt
from libplacebo_tpu_torch.core import film_grain as tcfg
from libplacebo_tpu_torch.render import renderer as trr

LSB = 1.0 / 255.0


@pytest.fixture(autouse=True)
def _jax_fused_tail(monkeypatch):
    monkeypatch.setenv("LPTPU_FUSED_COLORMAP", "1")


def test_path_g_twelve_vsyncs():
    """Path G over vsyncs 0-11 (source frames 0-5): the port's queue,
    fed lazily, against the JAX queue fed the same frames; every mix
    identical, each rendered frame mixed within path E's gate, each
    source frame mapped once and rendered once on K1 (no dither), the
    rest mix-cache hits; telemetry one frame late."""
    yuvs = chip_smoke._flagship_yuv(8, 64, 128, seed=21, bits=10)
    params_t = chip_smoke.path_g_params(lt)
    jo = __import__("libplacebo_tpu.core.options",
                    fromlist=["Options"]).Options()
    jo.parse(chip_smoke.PATH_G_OPTIONS)
    params_j = jo.params
    assert params_t.frame_mixer == params_j.frame_mixer == "mitchell_clamp"
    decoder = chip_smoke.PathGDecoder(lt, yuvs, "cpu")
    jt = jr.Target(w=256, h=128, color=jcs.CSP_SRGB, bit_depth=8)
    tt = lt.Target(w=256, h=128, color=lt.CSP_SRGB, bit_depth=8)
    jrend, trend = jr.Renderer(), lt.Renderer(device="cpu")
    trend.telemetry = lt.Telemetry()
    jqueue = jq.FrameQueue()
    jmaps = []

    def jsource(k):
        def map_frame():
            jmaps.append(k)
            f = jfr.frame_from_yuv420p(
                *yuvs[k], color=jcs.CSP_BT2100_PQ, bit_depth=10,
                repr=jcs.ColorRepr(sys="bt.2020-nc", levels="limited",
                                   bits=jcs.BitEncoding(10, 10, 0)))
            f.signature = k + 1
            return f
        return jq.SourceFrame(pts=k / chip_smoke.PATH_G_FPS, map=map_frame)
    for k in range(len(yuvs)):
        jqueue.push(jsource(k))
    jqueue.push(None)
    seen = []

    def on_vsync(v, status, mix, out):
        jstatus, jmix = jqueue.update(jq.QueueParams(
            pts=v / chip_smoke.PATH_G_HZ,
            radius=jq.frame_mix_radius(params_j),
            vsync_duration=1 / chip_smoke.PATH_G_HZ),
            jq.QueueMode.INTERPOLATE)
        assert status.value == jstatus.value == "ok"
        assert [f.signature for f in mix.frames] == \
            [f.signature for f in jmix.frames]
        assert [f.pts for f in mix.frames] == [f.pts for f in jmix.frames]
        assert mix.timestamps == jmix.timestamps
        assert mix.vsync_duration == jmix.vsync_duration
        ref = np.asarray(jr.render_image_mix(jrend, jmix, jt, params_j))
        d = np.abs(out.numpy() - ref)
        assert (d > 1e-6).mean() < 1.2e-3, (d > 1e-6).mean()
        assert (d > LSB + 1e-6).mean() <= 1e-4, (d > LSB + 1e-6).mean()
        np.testing.assert_allclose(trend._peak_state.numpy(),
                                   np.asarray(jrend._peak_state), atol=1e-5)
        seen.append(len(mix.frames))
    trr.k1_tails = trr.plain_tails = trr.ineligible_tails = 0
    statuses = chip_smoke.path_g_play(lt, trend, decoder, tt, params_t,
                                      range(12), threaded=False,
                                      on_vsync=on_vsync)
    assert [s.value for s in statuses] == ["ok"] * 12 and len(seen) == 12
    rendered = trr.k1_tails
    assert (trr.plain_tails, trr.ineligible_tails) == (0, 0)
    assert rendered == len(set(jmaps)) == decoder.counts["map"]
    assert sum(seen) > rendered       # the rest were mix-cache hits
    # the queue was reset at the end: every mapped frame unmapped, every
    # other one discarded unseen
    assert decoder.counts["unmap"] == decoder.counts["map"]
    assert decoder.counts["map"] + decoder.counts["discard"] == len(yuvs)
    assert trend.telemetry.passes["frame"].count == rendered - 1
    trend.flush_telemetry()
    assert trend.telemetry.passes["frame"].count == rendered
    assert trend.get_errors() == (frozenset(), frozenset())


def _jax_hooks(weight):
    """Path H's hooks in jnp, as chip_smoke.path_h_hooks writes them in
    torch."""
    def doubler(img, params):
        x = jnp.pad(img[None], ((0, 0), (0, 0), (1, 1), (1, 1)), mode="edge")
        y = jax.lax.conv_general_dilated(
            x, jnp.asarray(weight), (1, 1), "VALID",
            precision=jax.lax.Precision.HIGHEST)[0]
        c, h, w = y.shape
        out = y.reshape(c // 4, 2, 2, h, w).transpose(0, 3, 1, 4, 2)
        params.rect.apply_pass(2.0, 2.0, off=(-0.5, -0.5))
        return out.reshape(c // 4, 2 * h, 2 * w)

    def exposure(img, params):
        mean = params.state_in["mean"] * 0.875 + img.mean() * 0.125
        params.state_out["mean"] = mean
        return img * (1.0 + (0.25 - mean) * 0.1)
    auto = jhooks.Hook(jhooks.HookStage.PRE_OUTPUT, exposure)
    auto.state_spec = {"mean": np.float32(0.25)}
    return [jhooks.Hook(jhooks.HookStage.LUMA_INPUT, doubler), auto]


def test_path_h_three_frames():
    """Path H over 3 chained frames (a new grain seed each): the hooked
    tail plain in both (counted ineligible), K2 and K3 after it, the
    frames within config 5's gate and the auto-exposure's carried mean
    equal; nothing disabled."""
    hooks_t, weight = chip_smoke.path_h_hooks(lt, "cpu")
    params_t = chip_smoke.path_h_params(lt, hooks_t)
    hooks_j = _jax_hooks(weight)
    params_j = jr.RenderParams(upscaler="ewa_lanczos",
                               deband=jdeband.DebandParams(iterations=2),
                               film_grain=True,
                               error_diffusion="floyd-steinberg",
                               hooks=tuple(hooks_j))
    jt = jr.Target(w=256, h=128, color=jcs.CSP_SRGB, bit_depth=8)
    tt = lt.Target(w=256, h=128, color=lt.CSP_SRGB, bit_depth=8)
    jrend, trend = jr.Renderer(), lt.Renderer(device="cpu")
    trr.k1_tails = trr.plain_tails = trr.ineligible_tails = 0
    grain = tcfg.sample_grain(7391)
    for i, yuv in enumerate(chip_smoke._flagship_yuv(3, 64, 128, seed=5)):
        jf = jfr.frame_from_yuv420p(*yuv, color=jcs.CSP_BT2100_PQ,
                                    repr=jcs.ColorRepr(
                                        sys="bt.2020-nc", levels="limited",
                                        bits=jcs.BitEncoding(8, 8, 0)))
        jf.film_grain = jcfg.FilmGrainData(
            type="av1", seed=7391 + i,
            av1=jcfg.AV1GrainData(**dataclasses.asdict(grain.av1)))
        tf = chip_smoke._frame(lt, yuv, "cpu",
                               dataclasses.replace(grain, seed=7391 + i))
        ref = np.asarray(jrend.render(jf, jt, params_j))
        out = trend.render(tf, tt, params_t).numpy()
        assert out.shape == ref.shape == (3, 128, 256)
        np.testing.assert_allclose(out * 255, np.round(out * 255), atol=1e-3)
        d = np.abs(out - ref)
        assert (d > LSB + 1e-6).mean() <= 5e-4, (d > LSB + 1e-6).mean()
        assert (d > 1e-6).mean() < 0.12, (d > 1e-6).mean()
        assert 10 * np.log10(1.0 / max((d ** 2).mean(), 1e-12)) >= 45
        mj = float(np.asarray(jrend._hook_states[(hooks_j[1].signature,
                                                  "mean")]))
        mt = float(trend._hook_states[(hooks_t[1].signature, "mean")])
        assert abs(mt - mj) <= 1e-6, (mt, mj)
    assert (trr.k1_tails, trr.plain_tails, trr.ineligible_tails) == (0, 0, 3)
    assert len(trend._cache) == 1
    assert trend.get_errors() == jrend.get_errors() == (frozenset(),
                                                        frozenset())

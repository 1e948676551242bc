"""PyTorch port: the renderer's degradation ladder against the JAX
package on the CPU, and the rule the port adds to it: a kernel's
failure to build or launch (KernelError) and a CUDA error never
degrade — they propagate, with nothing recorded in `errors`.

Stages are broken by monkeypatching the same stage in both packages, as
tests/test_render.py breaks deband.  Tolerances: the degradation flags
and the log exactly; the frames within the gate of K1's perceptual
tail after an EWA (tests/test_torch_presentation.py: fewer than 1.2e-3
of the values differing, more than 1 LSB on at most 1e-4 — F1's
last-ulp differences magnified on knife-edge pixels; measured here
3.7e-4 and 2.0e-5, the same without a broken stage).
"""
import numpy as np
import pytest
import torch

from libplacebo_tpu.core import colorspace as jcs
from libplacebo_tpu.core import log as jlog
from libplacebo_tpu.ops import deband as jdeband
from libplacebo_tpu.ops import peak_detect as jpeak
from libplacebo_tpu.render import frame as jfr
from libplacebo_tpu.render import renderer as jr

import libplacebo_tpu_torch as lt
from libplacebo_tpu_torch import _build
from libplacebo_tpu_torch.core import log as tlog
from libplacebo_tpu_torch.ops import deband as tdeband
from libplacebo_tpu_torch.ops import peak_detect as tpeak
from libplacebo_tpu_torch.ops.cuda import color_map as k1
from libplacebo_tpu_torch.ops.cuda import error_diffusion as k2
from libplacebo_tpu_torch.render import renderer as trr

LSB = 1.0 / 255.0


@pytest.fixture(autouse=True)
def _jax_fused_tail(monkeypatch):
    monkeypatch.setenv("LPTPU_FUSED_COLORMAP", "1")


@pytest.fixture
def logs(monkeypatch):
    """Each package's error log, captured."""
    out = {"j": [], "t": []}
    monkeypatch.setattr(jlog, "default_log", lambda: jlog.Log(
        level=jlog.LogLevel.ERR, callback=lambda lvl, m: out["j"].append(m)))
    monkeypatch.setattr(tlog, "default_log", lambda: tlog.Log(
        level=tlog.LogLevel.ERR, callback=lambda lvl, m: out["t"].append(m)))
    return out


def _yuv(seed, h=32, w=128):
    rng = np.random.default_rng(seed)
    return ((rng.random((h, w)) * 219 + 16).astype(np.uint8),
            (rng.random((h // 2, w // 2)) * 224 + 16).astype(np.uint8),
            (rng.random((h // 2, w // 2)) * 224 + 16).astype(np.uint8))


def _pair(seed):
    """The flagship's content (8-bit limited BT.2020-NC PQ) at 32x128 in
    both packages, and their 64x256 8-bit sRGB targets."""
    yuv = _yuv(seed)
    jf = jfr.frame_from_yuv420p(
        *yuv, color=jcs.CSP_BT2100_PQ, repr=jcs.ColorRepr(
            sys="bt.2020-nc", levels="limited",
            bits=jcs.BitEncoding(8, 8, 0)))
    tf = lt.frame_from_yuv420p(*yuv, color=lt.CSP_BT2100_PQ, device="cpu",
                               repr=lt.ColorRepr(sys="bt.2020-nc",
                                                 levels="limited",
                                                 bits=lt.BitEncoding(8, 8, 0)))
    return (jf, jr.Target(w=256, h=64, color=jcs.CSP_SRGB, bit_depth=8),
            tf, lt.Target(w=256, h=64, color=lt.CSP_SRGB, bit_depth=8))


def _gate(out_t, out_j):
    d = np.abs(out_t - out_j)
    assert (d > 1e-6).mean() < 1.2e-3, (d > 1e-6).mean()
    assert (d > LSB + 1e-6).mean() <= 1e-4, (d > LSB + 1e-6).mean()


def _broken(*a, **k):
    raise RuntimeError("synthetic backend failure")


def _render_both(params_kw, frames=2):
    """Render `frames` chained frames in both packages, `params_kw` giving
    each package's extra RenderParams fields from its deband module;
    returns the two renderers."""
    jrend, trend = jr.Renderer(), lt.Renderer(device="cpu")
    for seed in range(frames):
        jf, jt, tf, tt = _pair(seed)
        out_j = np.asarray(jrend.render(jf, jt, jr.RenderParams(
            upscaler="ewa_lanczos", **params_kw(jdeband))))
        out_t = trend.render(tf, tt, lt.RenderParams(
            upscaler="ewa_lanczos", **params_kw(tdeband))).numpy()
        _gate(out_t, out_j)
    return jrend, trend


def test_broken_deband_degrades_in_both(monkeypatch, logs):
    """Deband broken in both packages: each re-renders without it,
    records `deband`, logs it once, and leaves it out of the next frame
    without failing again."""
    monkeypatch.setattr(jdeband, "deband", _broken)
    monkeypatch.setattr(tdeband, "deband", _broken)
    jrend, trend = _render_both(lambda m: dict(deband=m.DebandParams()))
    assert trend.errors == jrend.errors == {"deband"}
    assert trend.get_errors() == (frozenset({"deband"}), frozenset())
    assert len(logs["t"]) == len(logs["j"]) == 1
    assert "deband" in logs["t"][0] and \
        "synthetic backend failure" in logs["t"][0]


def test_two_broken_stages_strip_cumulatively(monkeypatch, logs):
    """Deband and the delayed peak stats (which the same-frame stats of a
    plain tail use too) broken: no single rung recovers, so both
    packages strip cumulatively — the fused tail, grain, deband, then
    peak detection — and record the same flags."""
    for mod, peak in ((jdeband, jpeak), (tdeband, tpeak)):
        monkeypatch.setattr(mod, "deband", _broken)
        monkeypatch.setattr(peak, "delayed_stats", _broken)
    jrend, trend = _render_both(lambda m: dict(deband=m.DebandParams()))
    assert trend.errors == jrend.errors == {"fused_colormap", "film_grain",
                                            "deband", "peak_detect"}
    assert len(logs["t"]) == len(logs["j"]) == 1


@pytest.mark.parametrize("case", ["value_error", "render_error"])
def test_user_errors_propagate(case):
    """A ValueError (an unknown overlay mode) and a RenderError (a
    singular distortion) leave Renderer.render unchanged; nothing
    degrades.  (An unknown filter raises RenderError, as in the
    reference: tests/test_torch_runtime.py::test_bad_scaler_name_raises.)"""
    _, _, tf, tt = _pair(0)
    r = lt.Renderer(device="cpu")
    if case == "value_error":
        tf.overlays = [lt.Overlay(torch.zeros((4, 4, 4)), mode="bogus")]
        params, exc = lt.RenderParams(), ValueError
    else:
        params, exc = lt.RenderParams(distort=lt.DistortParams(
            transform=((0.0, 0.0), (0.0, 0.0)))), lt.RenderError
    with pytest.raises(exc):
        r.render(tf, tt, params)
    assert r.get_errors() == (frozenset(), frozenset())


@pytest.mark.parametrize("kernel", ["k1", "k2"])
@pytest.mark.parametrize("error", ["kernel_error", "cuda_error"])
def test_kernel_failures_never_degrade(kernel, error, monkeypatch, logs):
    """K1's or K2's entry (their plain versions, on the CPU) made to
    raise a KernelError, or the exception torch raises for a CUDA error:
    it propagates out of Renderer.render — the fused_colormap and
    error_diffusion rungs would otherwise hide it behind a plain render
    — and `errors` stays empty, with nothing logged."""
    # torch.AcceleratorError where the installed torch has it
    cuda_error = getattr(torch, "AcceleratorError", RuntimeError)
    exc = lt.KernelError("launch failed: synthetic") \
        if error == "kernel_error" else \
        cuda_error("CUDA error: an illegal memory access was encountered")

    def fail(*a, **k):
        raise exc
    if kernel == "k1":
        monkeypatch.setattr(k1, "tail_plain", fail)
        params = lt.RenderParams(upscaler="ewa_lanczos")
    else:
        monkeypatch.setattr(k2, "wavefront_plain", fail)
        params = lt.RenderParams(upscaler="ewa_lanczos",
                                 error_diffusion="floyd-steinberg")
    _, _, tf, tt = _pair(0)
    r = lt.Renderer(device="cpu")
    with pytest.raises(type(exc), match="synthetic|CUDA error"):
        r.render(tf, tt, params)
    assert r.get_errors() == (frozenset(), frozenset()) and not logs["t"]


def test_reset_errors():
    """reset_errors clears the named flags and hooks, or everything;
    a recorded flag strips its feature from later frames up front."""
    _, _, tf, tt = _pair(0)
    r = lt.Renderer(device="cpu")
    r.errors.update({"deband", "dither"})
    r._disabled_hooks.add(7)
    trr.k1_tails = 0
    out = r.render(tf, tt, lt.RenderParams(upscaler="ewa_lanczos",
                                           deband=lt.DebandParams()))
    # the dither was stripped up front: the output is not 8-bit codes
    assert trr.k1_tails == 1
    assert float(np.abs(out.numpy() * 255 - np.round(out.numpy() * 255))
                 .max()) > 1e-3
    r.reset_errors(errors=["dither"])
    assert r.get_errors() == (frozenset({"deband"}), frozenset({7}))
    r.reset_errors(hooks=[7])
    assert r.get_errors() == (frozenset({"deband"}), frozenset())
    r.errors.add("film_grain")
    r._disabled_hooks.add(3)
    r.reset_errors()
    assert r.get_errors() == (frozenset(), frozenset())


def test_kernel_sites_raise_kernel_error():
    """Every site where a kernel fails to build, load or launch raises
    KernelError (a RuntimeError, so older callers still catch it): the
    wrappers' launch checks by their source, and a failed build for
    real."""
    import inspect
    from libplacebo_tpu_torch.ops.cuda import shear as k3
    for mod, n in ((k1, 3), (k2, 1), (k3, 1)):
        src = inspect.getsource(mod)
        assert src.count("raise KernelError(") == n, mod.__name__
        assert "raise RuntimeError(" not in src, mod.__name__
    assert issubclass(lt.KernelError, RuntimeError)
    with pytest.raises(lt.KernelError, match="build of k3_probe failed"):
        _build.build_shared("k3_probe", ["csrc/shear.cu"], "false", [])
    assert _build.is_kernel_failure(lt.KernelError("x"))
    assert _build.is_kernel_failure(RuntimeError("CUDA error: x"))
    assert not _build.is_kernel_failure(RuntimeError("other"))
    assert not _build.is_kernel_failure(ValueError("CUDA error: x"))
    assert not trr._degradable(lt.KernelError("nvcc not found"))


def _on_card(monkeypatch, fails):
    """A renderer taken for one on the card (its device type CUDA) whose
    render of a frame raises `fails(params)` where that is not None;
    returns it and the params of every render it tried."""
    r = lt.Renderer(device="cpu")
    r.device = torch.device("cuda")
    tried = []

    def render_once(frame, target, params):
        tried.append(params)
        exc = fails(params)
        if exc is not None:
            raise exc
        return torch.zeros((3, target.h, target.w))
    monkeypatch.setattr(r, "_render_once", render_once)
    return r, tried


def test_no_rung_swaps_a_kernel_on_the_card(monkeypatch, logs):
    """On the card no rung gives K1's work to its plain version: two
    plain stages broken (deband, and peak detection) strip cumulatively
    without the fused_colormap rung, which would only hide their failure
    behind a plain tail; no render is tried without the fused tail."""
    def fails(p):
        if p.deband is not None or p.peak_detect is not None:
            return RuntimeError("synthetic backend failure")
    r, tried = _on_card(monkeypatch, fails)
    _, _, tf, tt = _pair(0)
    r.render(tf, tt, lt.RenderParams(upscaler="ewa_lanczos",
                                     deband=lt.DebandParams()))
    assert r.get_errors() == (
        frozenset({"film_grain", "deband", "peak_detect"}), frozenset())
    assert not any(p.disable_fused_colormap for p in tried)
    assert len(logs["t"]) == 1 and "fused_colormap" not in logs["t"][0]
    # the CPU renderer keeps the reference's rung
    assert trr._ladder(torch.device("cpu"))[0][0] == "fused_colormap"
    assert "fused_colormap" not in dict(trr._ladder(torch.device("cuda")))


@pytest.mark.parametrize("error", [
    lambda: torch.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                   "95.00 MiB"),
    lambda: AttributeError("undefined symbol: k1_generic_launch"),
    lambda: OSError("libk1.so: cannot open shared object file")],
    ids=["out_of_memory", "stale_library", "missing_library"])
def test_kernel_work_failures_never_degrade(error, monkeypatch, logs):
    """Whatever fails inside a wrapper's work on the card (its outputs'
    allocation, its library, its launch) leaves it as a KernelError, so
    an out-of-memory error in K1's wrapper propagates out of
    Renderer.render with nothing recorded; every launch lies inside such
    a block (K1: a tail's instance, the static curve, the square-root
    check), and so does the build of a tail's instance, or of an
    error-diffusion pattern's, when the renderer plans it (K1's and K2's
    `prepare`)."""
    import inspect
    from libplacebo_tpu_torch.ops.cuda import shear as k3
    exc = error()
    with pytest.raises(lt.KernelError) as info:
        with _build.kernel_work("K1"):
            raise exc
    assert info.value.__cause__ is exc and not trr._degradable(info.value)
    assert type(exc).__name__ in str(info.value)

    def fails(p):
        with _build.kernel_work("K1"):
            raise error()
    r, tried = _on_card(monkeypatch, fails)
    _, _, tf, tt = _pair(0)
    with pytest.raises(lt.KernelError, match=type(exc).__name__):
        r.render(tf, tt, lt.RenderParams(upscaler="ewa_lanczos",
                                         error_diffusion="floyd-steinberg"))
    assert len(tried) == 1
    assert r.get_errors() == (frozenset(), frozenset()) and not logs["t"]
    for mod, n in ((k1, 4), (k2, 2), (k3, 1)):
        src = inspect.getsource(mod)
        assert src.count("with kernel_work(") == n, mod.__name__
        assert src.count("_launch(") == src.count(
            "_launch(", src.index("with kernel_work(")), mod.__name__

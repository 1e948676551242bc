"""The port's runtime context (runtime.py) and cache (core/cache.py)
against the JAX package's: tests/test_runtime.py's cases on the dummy
context, cache blobs crossed both ways byte for byte, the renderer's
context argument, save / load, and Frame.acquire / release."""
import numpy as np
import pytest
import torch

import libplacebo_tpu_torch as lt
from libplacebo_tpu import runtime as jruntime
from libplacebo_tpu.core import cache as jcache
from libplacebo_tpu.core.colorspace import CSP_SRGB as J_SRGB
from libplacebo_tpu.render.frame import frame_from_rgb as j_frame_from_rgb
from libplacebo_tpu.render.renderer import Renderer as JRenderer
from libplacebo_tpu.render.renderer import RenderError as JRenderError
from libplacebo_tpu.render.renderer import Target as JTarget
from libplacebo_tpu_torch import _build, runtime
from libplacebo_tpu_torch.core import cache as tcache
from libplacebo_tpu_torch.ops.cuda import color_map as k1


def _rgb(seed, h=16, w=16):
    return np.random.default_rng(seed).random((h, w, 3)).astype(np.float32)


def test_context_create():
    ctx = runtime.create_dummy()
    assert ctx.limits.num_devices >= 1 and ctx.limits.device_kind == "cpu"
    assert not ctx.limits.supports_kernels
    assert ctx.device.type == "cpu" and not ctx.is_failed
    assert isinstance(ctx.cache, tcache.Cache)


def test_context_upload_and_render_match_the_reference():
    """ctx.upload lands on the context's device; ctx.renderer() renders
    what the reference's context renders (sRGB -> sRGB, no dither)."""
    ctx = runtime.create_dummy()
    x = ctx.upload(np.ones((3, 8, 8), np.float32))
    assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
    assert float(x[0, 0, 0]) == 1.0
    r = ctx.renderer()
    assert r.ctx is ctx and r.device == ctx.device
    out = r.render(lt.frame_from_rgb(_rgb(0), color=lt.CSP_SRGB,
                                     device="cpu"),
                   lt.Target(w=16, h=16, color=lt.CSP_SRGB))
    want = jruntime.create_dummy().renderer().render(
        j_frame_from_rgb(_rgb(0), color=J_SRGB),
        JTarget(w=16, h=16, color=J_SRGB))
    assert tuple(out.shape) == (3, 16, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-6)


def test_context_mesh_is_not_ported_yet():
    """The context's mesh (ported since item 30): alone, a one-rank gloo
    group on the CPU context's device; a shape the world cannot hold
    raises."""
    mesh = runtime.create_dummy().make_mesh()
    try:
        assert mesh.shape == {"data": 1, "spatial": 1}
        assert mesh.device == torch.device("cpu")
        with pytest.raises(ValueError, match="ranks"):
            runtime.create_dummy().make_mesh(data=2, spatial=4)
    finally:
        mesh.close()


def test_bad_scaler_name_raises():
    """A bad scaler name is the user's error: it surfaces, nothing
    degrades (reference tests/test_runtime.py)."""
    r = lt.Renderer(device="cpu")
    frame = lt.frame_from_rgb(_rgb(1), color=lt.CSP_SRGB, device="cpu")
    p = lt.RenderParams(upscaler="no-such-filter", peak_detect=None,
                        dither=None)
    with pytest.raises(lt.RenderError, match="no-such-filter"):
        r.render(frame, lt.Target(w=32, h=32, color=lt.CSP_SRGB), p)
    assert not r.errors


def test_no_degradation_on_good_params():
    r = lt.Renderer(device="cpu")
    r.render(lt.frame_from_rgb(_rgb(2), color=lt.CSP_SRGB, device="cpu"),
             lt.Target(w=24, h=24, color=lt.CSP_SRGB))
    assert r.errors == set()


def test_disk_cache_sets_the_build_directory(tmp_path, monkeypatch):
    """set_disk_cache points the kernel build directory at the path:
    libraries built from then on land there, and rendering still works."""
    from libplacebo_tpu_torch import native
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    ctx = runtime.create_dummy()
    ctx.set_disk_cache(str(tmp_path / "plcache"))
    assert _build.BUILD_DIR == str(tmp_path / "plcache")
    paths = _build.build_all(native.build_specs()[:1])
    assert all(p.startswith(str(tmp_path / "plcache")) for p in paths)
    out = ctx.renderer().render(
        lt.frame_from_rgb(_rgb(5, 8, 8), color=lt.CSP_SRGB, device="cpu"),
        lt.Target(w=8, h=8, color=lt.CSP_SRGB))
    assert tuple(out.shape) == (3, 8, 8)


def test_timer_nonblocking_inorder():
    """Timer on the CPU: in-order readings, None when nothing new, a
    stop() without start() raises (reference pl_timer contract)."""
    t = runtime.create_dummy().timer()
    assert t.query() is None
    for _ in range(2):
        t.start()
        out = torch.ones((64, 64)) * 2.0
        t.stop(out)
    a, b = t.query(), t.query()
    assert a is not None and b is not None and a >= 0.0 and b >= 0.0
    assert t.query() is None
    with pytest.raises(RuntimeError):
        t.stop(out)


class _FakeEvent:
    """A CUDA event stand-in: finished once `done` is set; reading the
    time of an unfinished event is what would block, so it fails."""
    clock = 0.0

    def __init__(self, enable_timing=True):
        self.done = False
        self.t = None

    def record(self):
        _FakeEvent.clock += 1.5
        self.t = _FakeEvent.clock

    def query(self):
        return self.done

    def elapsed_time(self, other):
        assert self.done and other.done, "read before it finished"
        return other.t - self.t


def test_timer_on_cuda_events_never_waits(monkeypatch):
    """On a CUDA device the timer reads only finished event pairs, in
    order, and returns None while the oldest is still running."""
    made = []

    def event(enable_timing=True):
        made.append(_FakeEvent())
        return made[-1]
    monkeypatch.setattr(torch.cuda, "Event", event)
    t = runtime.Timer(torch.device("cuda"))
    for _ in range(2):
        t.start()
        t.stop()
    assert len(made) == 4 and t.query() is None
    made[2].done = made[3].done = True       # the second pair finished
    assert t.query() is None                 # in order: the first waits
    made[0].done = made[1].done = True
    readings = [t.query(), t.query()]
    assert readings == [pytest.approx(1.5e-3)] * 2
    assert t.query() is None


def test_check_alive_and_mark_failed(monkeypatch):
    ctx = runtime.create_dummy()
    assert ctx.check_alive() and not ctx.is_failed
    ctx.mark_failed()
    assert ctx.is_failed
    ctx = runtime.create_dummy()

    def lost(*a, **k):
        raise RuntimeError("CUDA error: device lost")
    monkeypatch.setattr(ctx, "upload", lost)
    assert not ctx.check_alive() and ctx.is_failed


# -- the cache: the same wire format as the reference's -----------------

def _fill(cache, seed):
    rng = np.random.default_rng(seed)
    keys = [0, 1, 2 ** 64 - 1, 0x9E3779B97F4A7C15] + \
        [int(k) for k in rng.integers(0, 2 ** 63, 6)]
    for i, k in enumerate(keys):
        cache.set(k, rng.integers(0, 256, 1 + 97 * i).astype(np.uint8)
                  .tobytes())
    cache.set(keys[5], None)                 # a deletion
    return keys


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cache_blobs_cross_byte_for_byte(direction):
    src_mod, dst_mod = (jcache, tcache) if direction == "jax_to_port" \
        else (tcache, jcache)
    src = src_mod.Cache()
    keys = _fill(src, 3)
    blob = src.save()
    dst = dst_mod.Cache()
    assert dst.load(blob) == src.num_objects == len(keys) - 1
    assert dst.save() == blob
    assert dst.signature() == src.signature()
    assert sorted(dst.iterate()) == sorted(src.iterate())
    assert dst.total_size == src.total_size


@pytest.mark.parametrize("damage", ["magic", "version", "checksum",
                                    "truncated", "trailing", "empty"])
def test_cache_load_drops_what_the_reference_drops(damage):
    src = jcache.Cache()
    _fill(src, 4)
    blob = bytearray(src.save())
    if damage == "magic":
        blob[0] ^= 1
    elif damage == "version":
        blob[8] = 7
    elif damage == "checksum":
        blob[16 + 20 + 3] ^= 0xFF            # the first payload
    elif damage == "truncated":
        blob = blob[:len(blob) - 50]
    elif damage == "trailing":
        blob += b"\x00" * 13
    else:
        blob = blob[:12]
    got, want = tcache.Cache(), jcache.Cache()
    assert got.load(bytes(blob)) == want.load(bytes(blob))
    assert got.save() == want.save()


@pytest.mark.parametrize("params", [dict(max_object_size=300),
                                    dict(max_total_size=700),
                                    dict(max_total_size=1500)])
def test_cache_limits_and_eviction_match(params, monkeypatch):
    """Rejection and least-recently-used eviction, on one clock for both
    packages."""
    clock = iter(np.arange(1000.0))
    for mod in (jcache, tcache):
        monkeypatch.setattr(mod.time, "monotonic", lambda: next(clock))
    caches = [jcache.Cache(jcache.CacheParams(**params)),
              tcache.Cache(tcache.CacheParams(**params))]
    rng = np.random.default_rng(5)
    ops = [(int(k), int(n)) for k, n in zip(rng.integers(0, 8, 40),
                                            rng.integers(1, 400, 40))]
    for key, size in ops:
        results = [c.try_set(key, bytes(size)) for c in caches]
        assert results[0] == results[1]
        if size % 3 == 0:
            assert caches[0].get((key + 1) % 8) == caches[1].get(
                (key + 1) % 8)
        assert caches[0].save() == caches[1].save()


def test_cache_files_and_backing_store(tmp_path):
    stored = {}
    c = tcache.cache_create(tcache.CacheParams(
        set=stored.__setitem__, get=stored.get))
    c.set(7, b"seven")
    assert stored == {7: b"seven"}
    path = str(tmp_path / "c.bin")
    c.save_file(path)
    j = jcache.Cache()
    assert j.load_file(path) == 1 and j.get(7) == b"seven"
    fresh = tcache.Cache(tcache.CacheParams(get=stored.get))
    assert fresh.get(7) == b"seven" and fresh.num_objects == 1
    assert tcache.Cache().load_file(str(tmp_path / "missing")) == 0


def test_context_cache_carries_from_the_reference():
    from libplacebo_tpu_torch.carry import cache_from_saved
    jctx = jruntime.create_dummy()
    _fill(jctx.cache, 6)
    ctx = runtime.create_dummy()
    cache_from_saved(jctx.cache.save(), ctx.cache)
    assert ctx.cache.save() == jctx.cache.save()


# -- the renderer's context, save and load -------------------------------

@pytest.mark.parametrize("how", ["ctx_positional", "ctx_keyword",
                                 "device_positional", "device_keyword"])
def test_renderer_takes_a_context_or_a_device(how):
    ctx = runtime.create_dummy()
    r = {"ctx_positional": lambda: lt.Renderer(ctx),
         "ctx_keyword": lambda: lt.Renderer(ctx=ctx),
         "device_positional": lambda: lt.Renderer("cpu"),
         "device_keyword": lambda: lt.Renderer(device="cpu")}[how]()
    assert r.device.type == "cpu"
    assert r.ctx is (ctx if how.startswith("ctx") else None)
    with pytest.raises(TypeError):
        lt.Renderer(ctx, device="cpu")
    with pytest.raises(TypeError):
        lt.Renderer("cpu", device="cpu")


def test_save_and_load_go_through_the_context_cache():
    assert lt.Renderer(device="cpu").save() == b""
    assert lt.Renderer(device="cpu").load(b"anything") == 0
    ctx = runtime.create_dummy()
    keys = _fill(ctx.cache, 7)
    r = lt.Renderer(ctx)
    blob = r.save()
    jr = JRenderer(jruntime.create_dummy())
    assert jr.load(blob) == len(keys) - 1 and jr.save() == blob
    fresh = lt.Renderer(ctx=runtime.create_dummy())
    assert fresh.load(blob) == len(keys) - 1 and fresh.save() == blob
    assert fresh.load(b"") == 0


# -- acquire / release ---------------------------------------------------

def _logged_frames(pkg, log, refuse=()):
    """A frame and its two neighbor frames whose acquire / release append
    to `log`; the names in `refuse` refuse the acquire."""
    make = (lambda rgb: lt.frame_from_rgb(rgb, color=lt.CSP_SRGB,
                                          device="cpu")) if pkg == "port" \
        else (lambda rgb: j_frame_from_rgb(rgb, color=J_SRGB))
    frames = {}
    for i, name in enumerate(("frame", "prev", "next")):
        f = make(_rgb(10 + i))
        f.acquire = (lambda f_, n=name: log.append(("acquire", n))
                     or n not in refuse)
        f.release = lambda f_, n=name: log.append(("release", n))
        frames[name] = f
    return frames


def _render_logged(pkg, with_neighbors, refuse=(), fail=None):
    log = []
    fr = _logged_frames(pkg, log, refuse)
    frame = fr["frame"]
    if with_neighbors:
        frame.prev, frame.next = fr["prev"], fr["next"]
    if pkg == "port":
        r = lt.Renderer(device="cpu")
        target = lt.Target(w=16, h=16, color=lt.CSP_SRGB)
        err = lt.RenderError
    else:
        r, target, err = JRenderer(), JTarget(w=16, h=16, color=J_SRGB), \
            JRenderError
    try:
        r.render(frame, target)
        raised = None
    except Exception as e:  # noqa: BLE001 - compared below
        raised = e
    return log, raised, err


@pytest.mark.parametrize("with_neighbors", [False, True])
@pytest.mark.parametrize("refuse", [(), ("frame",), ("next",)])
def test_acquire_release_match_the_reference(with_neighbors, refuse):
    """The frame (and its neighbors) acquired before the render, in order,
    a refusal raising RenderError, and every release run afterwards: the
    same calls as the reference's renderer makes."""
    got, g_exc, g_err = _render_logged("port", with_neighbors, refuse)
    want, w_exc, w_err = _render_logged("jax", with_neighbors, refuse)
    assert got == want
    refused = "frame" in refuse or (with_neighbors and refuse)
    assert isinstance(g_exc, g_err) if refused else g_exc is None
    assert isinstance(w_exc, w_err) if refused else w_exc is None
    assert [c for c in got if c[0] == "release"] == [
        ("release", n) for n in (("frame", "prev", "next")
                                 if with_neighbors else ("frame",))]


@pytest.mark.parametrize("failure", ["kernel", "user"])
def test_release_runs_after_a_failure(failure, monkeypatch):
    """A KernelError from K1's wrapper (never degraded) and a user error
    both propagate, after the frame's release ran."""
    log = []
    rng = np.random.default_rng(8)
    y = (rng.random((16, 128)) * 219 + 16).astype(np.uint8)
    uv = (rng.random((8, 64)) * 224 + 16).astype(np.uint8)
    frame = lt.frame_from_yuv420p(
        y, uv, uv, color=lt.CSP_BT2100_PQ, device="cpu",
        repr=lt.ColorRepr(sys=lt.ColorSystem.BT_2020_NC,
                          levels=lt.ColorLevels.LIMITED,
                          bits=lt.BitEncoding(8, 8, 0)))
    frame.acquire = lambda f: log.append(("acquire", "frame")) or True
    frame.release = lambda f: log.append(("release", "frame"))

    def broken(*a, **k):
        raise _build.KernelError("synthetic K1 failure")
    if failure == "kernel":
        monkeypatch.setattr(k1, "color_map_tail", broken)
        params = None
        exc = lt.KernelError
    else:
        params = lt.RenderParams(upscaler="no-such-filter")
        exc = lt.RenderError
    r = lt.Renderer(device="cpu")
    with pytest.raises(exc):
        r.render(frame, lt.Target(w=256, h=32, color=lt.CSP_SRGB,
                                  bit_depth=8), params)
    assert log == [("acquire", "frame"), ("release", "frame")]
    assert r.get_errors() == (frozenset(), frozenset())

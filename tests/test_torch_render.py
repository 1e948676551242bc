"""PyTorch port: kernel K1 on the flagship's tail, and the flagship
render against the JAX package.

The JAX side runs its fused tail (ops/pallas/color_map.py in interpret
mode, forced with LPTPU_FUSED_COLORMAP=1 as tests/test_render.py does),
because that is the semantics the port's main path has: peak partials
per 8-row stripe, measured inside the color-map pass.

Tolerance.  Both sides dither to 8 bits, so a last-ulp difference
upstream (see tests/test_torch_ops.py) flips a knife-edge pixel by one
LSB: the whole render, where the decode's and the EWA sum's rounding
enter too, is held to the gate of tests/test_render.py's fused-vs-plain
test (max <= 1 LSB, fewer than 1e-3 of values differing; measured
<= 4.5e-4), peak state atol 1e-5.  K1's plain version of each tail is
held against the reference's fused tail by
tests/test_torch_color_tails.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

from libplacebo_tpu.core import colorspace as jcs
from libplacebo_tpu.render.frame import frame_from_yuv420p as j_frame
from libplacebo_tpu.render.renderer import RenderParams as JParams
from libplacebo_tpu.render.renderer import Renderer as JRenderer
from libplacebo_tpu.render.renderer import Target as JTarget

import libplacebo_tpu_torch as lt
from libplacebo_tpu_torch import carry
from libplacebo_tpu_torch.core import colorspace as tcs
from libplacebo_tpu_torch.core.common import RectF as TRectF
from libplacebo_tpu_torch.core.fastmath import fma
from libplacebo_tpu_torch.ops.cuda import color_map as k1
from libplacebo_tpu_torch.render import renderer as trender

LSB = 1.0 / 255.0
SRC_H, SRC_W = 64, 128


def _yuv_frames(n, seed=3, h=SRC_H, w=SRC_W):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        y = (rng.random((h, w)) * 219 + 16).astype(np.uint8)
        u = (rng.random((h // 2, w // 2)) * 224 + 16).astype(np.uint8)
        v = (rng.random((h // 2, w // 2)) * 224 + 16).astype(np.uint8)
        out.append((y, u, v))
    return out


def _jax_frame(y, u, v):
    return j_frame(y, u, v, color=jcs.CSP_BT2100_PQ, repr=jcs.ColorRepr(
        sys=jcs.ColorSystem.BT_2020_NC, levels=jcs.ColorLevels.LIMITED,
        bits=jcs.BitEncoding(8, 8, 0)))


def _port_frame(y, u, v, device="cpu"):
    return lt.frame_from_yuv420p(
        y, u, v, color=lt.CSP_BT2100_PQ, device=device,
        repr=lt.ColorRepr(sys=lt.ColorSystem.BT_2020_NC,
                          levels=lt.ColorLevels.LIMITED,
                          bits=lt.BitEncoding(8, 8, 0)))


_J_TARGET = JTarget(w=2 * SRC_W, h=2 * SRC_H, color=jcs.CSP_SRGB,
                    bit_depth=8)
_T_TARGET = lt.Target(w=2 * SRC_W, h=2 * SRC_H, color=lt.CSP_SRGB,
                      bit_depth=8)
_J_PARAMS = JParams(upscaler="ewa_lanczos")
_T_PARAMS = lt.RenderParams(upscaler="ewa_lanczos")


def _port_tail(h, w, params=_T_PARAMS):
    ts, td = tcs.color_space_infer_map(lt.CSP_BT2100_PQ, lt.CSP_SRGB)
    target = lt.Target(w=w, h=h, color=lt.CSP_SRGB, bit_depth=8)
    return lt.Renderer(device="cpu")._fused_tail(
        params, ts, td, target, True, w, h, TRectF(0, 0, w, h))


def _linear_input(h, w, seed=11):
    rng = np.random.default_rng(seed)
    # PQ-range linear light with out-of-gamut and negative excursions,
    # like the EWA output of noise
    return (rng.random((3, h, w)) * 30.0 - 1.0).astype(np.float32)


def _assert_render_parity(out, ref):
    diff = np.abs(out - ref)
    assert diff.max() <= LSB + 1e-6, diff.max()
    assert (diff > 1e-6).mean() < 1e-3, (diff > 1e-6).mean()


def _jax_renders(frames, monkeypatch, renderer=None):
    monkeypatch.setenv("LPTPU_FUSED_COLORMAP", "1")
    r = renderer or JRenderer()
    outs, states = [], []
    for f in frames:
        outs.append(np.asarray(r._render_once(_jax_frame(*f), _J_TARGET,
                                              _J_PARAMS)))
        states.append(np.asarray(r._peak_state))
    return outs, states, r


def test_flagship_render_three_frames(monkeypatch):
    """The slice end to end: 3 chained frames 64x128 -> 128x256, peak
    state carried, port on the CPU vs the reference's fused path."""
    frames = _yuv_frames(3)
    refs, states, _ = _jax_renders(frames, monkeypatch)
    r = lt.Renderer(device="cpu")
    for f, ref, st in zip(frames, refs, states):
        out = r.render(_port_frame(*f), _T_TARGET, _T_PARAMS)
        assert out.shape == (3, 2 * SRC_H, 2 * SRC_W)
        _assert_render_parity(out.numpy(), ref)
        np.testing.assert_allclose(r._peak_state.numpy(), st, atol=1e-5)


def test_flagship_render_from_carried_state(monkeypatch):
    """The port starts mid-stream from the reference's frame-1 state
    (carry.py), then renders frames 2 and 3."""
    frames = _yuv_frames(3, seed=5)
    refs, states, jr = _jax_renders(frames[:1], monkeypatch)
    r = carry.renderer_state_from_jax(states[0], jr._frame_idx,
                                      device="cpu")
    assert r._frame_idx == 1
    refs2, states2, _ = _jax_renders(frames[1:], monkeypatch, renderer=jr)
    for f, ref, st in zip(frames[1:], refs2, states2):
        jf = _jax_frame(*f)
        tf = carry.frame_from_numpy(
            [(np.asarray(p.data), p.component_mapping) for p in jf.planes],
            _port_frame(*f).repr, lt.CSP_BT2100_PQ, device="cpu",
            shifts=[(p.shift_x, p.shift_y) for p in jf.planes])
        out = r.render(tf, _T_TARGET, _T_PARAMS)
        _assert_render_parity(out.numpy(), ref)
        np.testing.assert_allclose(r._peak_state.numpy(), st, atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _capture_k1(monkeypatch):
    """Record K1's inputs on each call the renderer makes; returns the
    record and the real wrapper."""
    launch = k1.color_map_tail
    captured = []

    def capture(img, plan, spline, lut):
        captured.append((img.clone(), plan, spline.clone(), lut))
        return launch(img, plan, spline, lut)

    monkeypatch.setattr(k1, "color_map_tail", capture)
    return captured, launch


def _k1_inputs(monkeypatch, h=8, w=128, params=_T_PARAMS):
    """K1's inputs (img, plan, spline, lut) as the flagship's tail hands
    them over, on the CPU."""
    captured, _ = _capture_k1(monkeypatch)
    _port_tail(h, w, params)(torch.from_numpy(_linear_input(h, w)),
                             (torch.tensor(0.3), torch.tensor(0.7)))
    return captured[0]


def _flagship_consts(monkeypatch):
    return _k1_inputs(monkeypatch)[1].consts


def _old_kernel_masks(consts):
    """The kept-row masks as the kernel's per-block prologue derived
    them before they were planned on the host: bit r set when any
    coefficient of row r is nonzero."""
    masks = []
    for name in ("src_coefs", "dst_coefs"):
        cf = consts[k1._OFF[name]:k1._OFF[name] + 17 * 7]
        mask = 0
        for r in range(17):
            for d in range(7):
                if cf[r * 7 + d] != 0.0:
                    mask |= 1 << r
        masks.append(mask)
    return masks


@pytest.mark.parametrize("zeroed", [None, ("dst_coefs", 5),
                                    ("src_coefs", 0)])
def test_k1_row_masks_match_kernel_rule(monkeypatch, zeroed):
    """The row masks planned on the host (TailPlan.rows, compiled into
    the tail's instance) are the masks the kernel once derived per
    block, for the flagship plan and with one row zeroed; the swap bits
    are mix's fusing rule per row.  A plan derives its masks from its
    own read-only copy of the constants, so the two cannot drift
    apart."""
    x, plan, spline, lut = _k1_inputs(monkeypatch)
    consts, rows = plan.consts, plan.rows
    assert rows == k1.row_masks(consts)
    assert not consts.flags.writeable
    assert rows.src_kept == rows.dst_kept == (1 << 17) - 1
    c = consts.copy()
    if zeroed is not None:
        off = k1._OFF[zeroed[0]] + 7 * zeroed[1]
        c[off:off + 7] = 0.0
    got = k1.TailPlan(c, plan.generic, plan.lut).rows
    assert got == k1.row_masks(c)
    assert [got.src_kept, got.dst_kept] == _old_kernel_masks(c)
    if zeroed is not None:
        assert not (got._asdict()[zeroed[0][:3] + "_kept"] >> zeroed[1]) & 1
    for name, swap in (("src_coefs", got.src_swap),
                       ("dst_coefs", got.dst_swap)):
        cf = c[k1._OFF[name]:k1._OFF[name] + 17 * 7].reshape(17, 7)
        for r in range(17):
            assert bool((swap >> r) & 1) == bool(cf[r, 0] < 0 < cf[r, 1])


def _mix_row(xs, w, code):
    """csrc/color_map.cu::mix_row of one matrix row with mix code
    `code` (color_map.py::_mix_code): its products, in its order."""
    acc = pend = None
    for k in range(3):
        if not (code >> k) & 1:
            continue
        one = (code >> (3 + k)) & 1
        if acc is None and pend is None:
            if one:
                acc = xs[k]
            else:
                pend = (xs[k], w[k])
        elif pend is not None:
            if one:
                acc = fma(pend[0], pend[1], xs[k])
            elif (code >> 6) & 1:
                acc = fma(xs[k], w[k], pend[0] * pend[1])
            else:
                acc = fma(pend[0], pend[1], xs[k] * w[k])
            pend = None
        elif one:
            acc = acc + xs[k]
        else:
            acc = fma(xs[k], w[k], acc)
    return pend[0] * pend[1] if pend is not None else acc


@pytest.mark.parametrize("w, swapped", [
    ((0.3, 0.5, 0.2), False), ((1.0, -0.4, 0.2), False),
    ((-0.4, 1.0, 0.6), False), ((-0.4, 0.7, 1.0), True),
    ((0.8, -0.4, 1.0), False), ((1.0, 1.0, -2.0), False),
    ((-1.5, 2.5, -0.25), True)])
def test_k1_matrix_row_form_is_mix(w, swapped):
    """The kernel's form of a matrix row (mix_row, its products and
    fusing order read from the row's mix code) is core/fastmath.py::mix
    bit for bit, weights of 1 included.  Both fusing orders are
    exercised, and on these inputs (all of one scale) the other order
    rounds differently wherever the first pair has no weight of 1."""
    from libplacebo_tpu_torch.core.fastmath import mix
    rng = np.random.default_rng(5)
    xs = [torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
          for _ in range(3)]
    code = k1._mix_code(w)
    assert bool((code >> 6) & 1) == swapped
    wf = [float(np.float32(v)) for v in w]
    want = mix(xs, wf)
    assert torch.equal(_mix_row(xs, wf, code), want), w
    other = _mix_row(xs, wf, code ^ (1 << 6))
    assert torch.equal(other, want) == (1.0 in wf[:2]), w


def test_k1_constants_fit_kernel_parameters(monkeypatch):
    """The packed constants travel as a kernel parameter, so they and
    the rest of the parameter list stay under the 4096-byte limit; the
    wrapper holds host memory only."""
    consts = _flagship_consts(monkeypatch)
    assert consts.dtype == np.float32 and consts.shape == (k1.NCONST,)
    assert k1.PARAM_BYTES == 4 * k1.NCONST + 5 * 8 + 4 * 4
    assert k1.PARAM_BYTES <= k1.PARAM_LIMIT == 4096


def test_k1_ops_per_pixel_counts_kept_rows(monkeypatch):
    """The operation count behind K1's bound follows the packed
    constants and ids: the flagship keeps all 17 rows of both boundary
    fits and dithers (1180 operations, as counted in ops/cuda/
    color_map.py); a pruned row (15) and a missing dither (12) are work
    the kernel skips."""
    plan = _k1_inputs(monkeypatch)[1]
    c, mode = plan.consts.copy(), plan.instance
    assert k1.ops_per_pixel(c, mode) == 1180
    off = k1._OFF["dst_coefs"] + 7 * 5
    c[off:off + 7] = 0.0
    assert k1.ops_per_pixel(c, mode) == 1180 - 15
    assert k1.ops_per_pixel(c, mode._replace(dither=0)) == 1180 - 15 - 12


@pytest.mark.cuda
def test_k1_kernel_matches_plain_on_card(cuda_device, monkeypatch):
    """K1 on the card vs its plain version on the inputs the renderer
    gives it for a small flagship frame: output within 1 LSB on < 1e-3
    of values, histograms equal, stripe sums rtol 1e-5 (their order
    differs)."""
    captured, launch = _capture_k1(monkeypatch)
    lt.Renderer(device=cuda_device).render(
        _port_frame(*_yuv_frames(1, seed=13)[0], device=cuda_device),
        _T_TARGET, _T_PARAMS)
    x, plan, spline, lut = captured[0]
    before = k1.launches
    out, part = launch(x, plan, spline, lut)
    assert k1.launches == before + 1
    ref, rpart = k1.tail_plain(x, plan, spline, lut)
    torch.cuda.synchronize()
    diff = (out - ref).abs()
    assert diff.max().item() <= LSB + 1e-6
    assert (diff > 1e-6).float().mean().item() < 1e-3
    assert torch.equal(part[:, 0], rpart[:, 0])
    torch.testing.assert_close(part[:, 1, :3], rpart[:, 1, :3], rtol=1e-5,
                               atol=0.0)


def _pq_to_linear(e):
    """Linear light (1.0 = 203 nits) whose PQ signal is `e` (BT.2100)."""
    m1, m2 = 2610 / 16384, 2523 / 4096 * 128
    c1, c2, c3 = 3424 / 4096, 2413 / 4096 * 32, 2392 / 4096 * 32
    p = np.power(e, 1 / m2)
    nits = 10000 * np.power(np.maximum(p - c1, 0) / (c2 - c3 * p), 1 / m1)
    return nits / 203.0


def _k1_frame(kind, h=16, w=256):
    """'dark': one constant colour, every pixel in histogram bin 0 (the
    worst case for the histogram's atomics); 'all_bins': PQ signals from
    0 to 1 along each row, so the 64 bins of PQ >= 0.5 all fill."""
    if kind == "dark":
        return np.broadcast_to(np.array([0.12, 0.10, 0.08], np.float32)
                               [:, None, None], (3, h, w)).copy()
    e = np.linspace(0.0, 1.0, h * w).reshape(h, w)
    lin = _pq_to_linear(e)
    tint = np.array([1.0, 0.6, 0.3])[:, None, None]
    return (lin[None] * tint).astype(np.float32)


def _k1_case(monkeypatch, device, kind, variant):
    """The flagship tail's K1 inputs for one frame kind: as planned, with
    row 5 of the target's boundary fit pruned (in the chain, so that the
    plain stages prune it too), or without dither."""
    params = _T_PARAMS
    if variant == "pruned_row":
        real = trender.color_chain

        def pruned(*args):
            chain = real(*args)
            coefs = [list(r) for r in chain.b_dst.coefs]
            coefs[5] = [0.0] * len(coefs[5])
            b_dst = dataclasses.replace(chain.b_dst, coefs=tuple(
                map(tuple, coefs)))
            return dataclasses.replace(chain, b_dst=b_dst)
        monkeypatch.setattr(trender, "color_chain", pruned)
    if variant == "no_dither":
        params = lt.RenderParams(upscaler="ewa_lanczos", dither=None)
    _, plan, spline, lut = _k1_inputs(monkeypatch, params=params)
    assert ((plan.rows.dst_kept >> 5) & 1) == (variant != "pruned_row")
    assert (lut is None) == (variant == "no_dither")
    img = torch.from_numpy(_k1_frame(kind)).to(device)
    return (img, plan, spline.to(device),
            lut.to(device) if lut is not None else None)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["flagship", "pruned_row", "no_dither"])
@pytest.mark.parametrize("kind", ["dark", "all_bins"])
def test_k1_kernel_exact_on_card(cuda_device, monkeypatch, kind, variant):
    """K1 against its plain version on a dark constant frame (one bin)
    and on a frame filling all 64 bins, with a pruned boundary row and
    without dither: outputs and histograms exactly equal, stripe sums
    rtol 1e-5 (their order differs)."""
    img, plan, spline, lut = _k1_case(monkeypatch, cuda_device, kind,
                                      variant)
    out, part = k1.color_map_tail(img, plan, spline, lut)
    ref, rpart = k1.tail_plain(img, plan, spline, lut)
    torch.cuda.synchronize()
    hist = rpart[:, 0, :64]
    if kind == "dark":
        assert int(hist[:, 0].sum()) == img.shape[1] * img.shape[2]
    else:
        assert bool((hist.sum(dim=0) > 0).all())
    assert torch.equal(out, ref)
    assert torch.equal(part[:, 0], rpart[:, 0])
    torch.testing.assert_close(part[:, 1, :3], rpart[:, 1, :3], rtol=1e-5,
                               atol=0.0)


@pytest.mark.cuda
def test_k1_kernel_partials_repeat_on_card(cuda_device, monkeypatch):
    """Two launches on the same input give identical partials: a
    stripe's block records are added in a fixed order."""
    args = _k1_case(monkeypatch, cuda_device, "all_bins", "flagship")
    out1, part1 = k1.color_map_tail(*args)
    out2, part2 = k1.color_map_tail(*args)
    torch.cuda.synchronize()
    assert torch.equal(part1, part2) and torch.equal(out1, out2)


@pytest.mark.cuda
def test_k1_sqrt_in_range_is_sqrtf_on_card(cuda_device, monkeypatch):
    """The check-free square root of K1's PQ curves equals sqrtf on
    every float of the range their clamps allow ([1e-8, 1]), in the
    flagship tail's library."""
    assert k1.sqrt_check(_k1_inputs(monkeypatch)[1], cuda_device) == 0
    torch.cuda.synchronize()

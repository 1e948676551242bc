"""K1 is compiled once a tail: the tail's ids, the mix codes of its
matrix rows, its fit-row masks and its switches become a generated
header (ops/cuda/color_map.py::generic_header), and the library built
from it is named by the header's hash.  These tests run
without nvcc: the header is a pure function of the plan's key, it says
what the plan says (the ids and mix codes read back from the text equal
the plan's, the codes recomputed from the chain's matrices), the build
specs name one library a distinct tail, and a build that cannot run
raises KernelError.  The compiled instances are held against their plain
version on the card by tests/test_torch_color_tails.py (`cuda`)."""
import re

import numpy as np
import pytest

from libplacebo_tpu_torch import _build
from libplacebo_tpu_torch.core.gamut_mapping import IPT2LMS, LMS2IPT
from libplacebo_tpu_torch.ops.cuda import color_map as k1
from libplacebo_tpu_torch.render import renderer as trender

from test_torch_color_tails import TAILS, _tail_setup

_H, _W = 16, 128


def _plan(key):
    ttail, *_ = _tail_setup(key, _H, _W)
    assert ttail is not None, key
    return ttail.plan


def _read(header):
    """{name: value} of the header's `constexpr int kG_<name>` lines and
    its mix-code table."""
    vals = {m.group(1): int(m.group(2)) for m in
            re.finditer(r"constexpr int kG_(\w+) = (-?\d+);", header)}
    codes, = re.findall(r"kCodes\[27\] = \{([^}]*)\}", header)
    return vals, [int(v) for v in codes.split(",")]


def _chain_codes(key, plan):
    """The 27 mix codes recomputed from the chain's own matrices, in the
    generic layout's order (plan_generic)."""
    _, _, _, (ts, td, tp, tt), use_peak = _tail_setup(key, _H, _W)
    chain = trender.color_chain(ts, td, tp, use_peak)
    _, enc_m, enc_pre = k1._g_encode(tt.repr, td.primaries)
    encode = [(enc_m[:9], enc_m[9:]), (enc_pre, None)]
    if chain.kind == "pass":
        m = chain.matrix if chain.matrix is not None else np.eye(3)
        return k1._mix_codes((m, None)) + [0] * 15 + \
            k1._mix_codes(*encode, (np.eye(3), None))
    g_abs = plan.consts[k1._OFF["g_abs"]:k1._OFF["g_abs"] + 9]
    return k1._mix_codes(
        (np.eye(3), None), (chain.b_src.rgb2lms, None), (LMS2IPT, None),
        (IPT2LMS, None), (chain.b_dst.lms2rgb, None),
        (chain.b_dst.rgb2lms, None), *encode, (g_abs, None))


@pytest.mark.parametrize("key", list(TAILS))
def test_k1_generic_header_reads_back_the_plan(key):
    """Each tail's header holds the plan's ids, its mix codes (equal to
    the codes recomputed from the chain's matrices), its fit-row masks
    and switches (generic_key), and nothing else."""
    plan = _plan(key)
    vals, codes = _read(plan.header)
    gkey = k1.generic_key(plan)
    assert tuple(vals[n] for n in k1.GenericMode._fields) == \
        tuple(plan.generic.mode)
    assert codes == _chain_codes(key, plan) == list(gkey.mix)
    assert tuple(vals[n] for n in k1._G_ROWS) == gkey.rows
    assert tuple(vals[n] for n in k1.G_SWITCHES) == gkey.switches
    assert len(vals) == len(k1.GenericMode._fields) + len(k1._G_ROWS) + \
        len(k1.G_SWITCHES)


def test_k1_generic_header_is_a_function_of_the_key():
    """The same plan gives the same text and digest; another mode id, mix
    code, row mask or switch changes both."""
    a, b = _plan("gamut-relative"), _plan("gamut-relative")
    assert a.header == b.header
    digest = _build.include_digest("k1_generic.h", a.header)
    assert digest == _build.include_digest("k1_generic.h", b.header)
    key = k1.generic_key(a)
    assert k1.generic_header(key) == a.header
    other = [key._replace(mode=key.mode._replace(trc=key.mode.trc + 1)),
             key._replace(mix=key.mix[:5] + (key.mix[5] ^ 8,) +
                          key.mix[6:]),
             key._replace(rows=(key.rows[0] + 1,) + key.rows[1:]),
             key._replace(switches=(3,) + key.switches[1:])]
    texts = {k1.generic_header(k) for k in other} | {a.header}
    assert len(texts) == len(other) + 1
    assert len({_build.include_digest("k1_generic.h", t)
                for t in texts}) == len(texts)


def test_k1_generic_key_switches():
    """The switches read the plan's constants as the kernel would: the
    static st2094-40 curve's Bernstein degree, the bt2390 knee, torch.
    pow's case of a plan-fixed exponent, the target's black scaling and
    the low-depth dither's steps; 0 where the chain has no such part."""
    sw = dict(zip(k1.G_SWITCHES, k1.generic_key(
        _plan("static-st2094-40")).switches))
    q = _plan("static-st2094-40").consts[k1._OFF["g_tone"] + 6:]
    assert sw["bezier"] == int(q[10]) > 0
    assert sw["st40_linear"] == int(q[7] != 0)
    sw = dict(zip(k1.G_SWITCHES, k1.generic_key(
        _plan("static-bt2390")).switches))
    assert sw["bezier"] == 0 and sw["bt2390_knee"] == 1
    assert sw["tone_pow"] == len(k1._POW_CASES)     # powf
    sw = dict(zip(k1.G_SWITCHES, k1.generic_key(
        _plan("low-depth-gamma")).switches))
    assert sw["dither_steps"] == 1 and sw["dither_pow"] == \
        k1._pow_case(_plan("low-depth-gamma").consts[k1._OFF["g_dith"]])
    sw = dict(zip(k1.G_SWITCHES, k1.generic_key(
        _plan("target-linear")).switches))
    assert sw["trc_scaled"] == 0
    assert [k1._pow_case(e) for e in (0.0, 1.0, 0.5, -1.0, 2.0, 3.0, 2.2)] \
        == list(range(7))


def test_k1_generic_rows_only_where_the_gamut_reads_them():
    """A gamut operator without boundary fits compiles no row masks (so
    such tails share a library across primaries); perceptual reads both
    fits, relative only the target's."""
    assert k1.generic_key(_plan("static-clip")).rows == (0, 0, 0, 0)
    rows = k1.generic_key(_plan("gamut-relative")).rows
    assert rows[0] == rows[2] == 0 and rows[1] != 0
    r = _plan("target-pq").rows
    assert k1.generic_key(_plan("target-pq")).rows == \
        (r.src_kept, r.dst_kept, r.src_swap, r.dst_swap)


def test_k1_build_specs_name_one_library_a_tail(monkeypatch, tmp_path):
    """build_specs(plans) makes one nvcc spec a distinct tail: built
    against the plan's header (written into the build directory), named
    by its digest."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "nvcc_path", lambda: "/usr/local/cuda/nvcc")
    plans = [_plan("gamut-relative"), _plan("white-noise"),
             _plan("gamut-relative")]
    specs = k1.build_specs(plans)
    assert len(specs) == 2
    for spec, plan in zip(specs, plans[:2]):
        name, sources, compiler, flags = spec
        assert name == "k1_color_map_g" + _build.include_digest(
            "k1_generic.h", plan.header)
        assert sources == ["csrc/color_map.cu"]
        inc = flags[flags.index("-I") + 1]
        with open(f"{inc}/k1_generic.h") as f:
            assert f.read() == plan.header
    assert k1.build_specs([]) == []


def test_k1_generic_build_failure_raises_kernel_error(monkeypatch):
    """Without a compiler the tail's instance cannot be built: prepare
    raises KernelError and nothing launches (no other instance, no plain
    tail, takes its place)."""
    def no_nvcc():
        raise _build.KernelError("nvcc not found")
    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    plan = _plan("static-hable")
    before = k1.launches
    with pytest.raises(_build.KernelError, match="nvcc not found"):
        k1.prepare(plan)
    assert k1.launches == before
    with pytest.raises(ValueError):
        k1.TailPlan(plan.consts, None)


@pytest.mark.parametrize("key", ["white-noise", "static-hable"])
def test_k1_generic_header_does_not_depend_on_the_frame_size(key):
    """A tail's header, and so its library, serves every frame size
    (white noise's bias is a launch argument, not part of the key);
    distinct tail kinds get distinct headers."""
    small, *_ = _tail_setup(key, _H, _W)
    large, *_ = _tail_setup(key, 64, 256)
    assert small.plan.header == large.plan.header
    assert small.plan.header != _plan("static-clip").header


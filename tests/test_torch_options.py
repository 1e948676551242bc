"""PyTorch port: the options table (core/options.py) against the JAX
package's, exactly — keys and their order, types, bounds, choices; every
option's round trip; save() strings on seeded random combinations; a
string saved by the JAX package parsed by the port to equal RenderParams
fields; the presets; the class of a parse error — and the log
(core/log.py).  mpv .hook text is not parsed yet (slice 4 item 29).
"""
import dataclasses
import enum
import zlib

import numpy as np
import pytest

from libplacebo_tpu.core import log as jlog
from libplacebo_tpu.core import options as jopt
from libplacebo_tpu.render import renderer as jr

import libplacebo_tpu_torch as lt
from libplacebo_tpu_torch.core import log as tlog
from libplacebo_tpu_torch.core import options as topt


def _desc(o):
    return (o.key, o.type, o.minimum, o.maximum, o.choices)


def test_table_parity():
    """Same keys in the same order, with the same types, bounds and
    choices."""
    assert [_desc(o) for o in topt.OPTION_TABLE()] == \
        [_desc(o) for o in jopt.OPTION_TABLE()]
    assert topt.find_option("upscaler").key == "upscaler"
    assert topt.find_option("no_such_option") is None


def _sample(o, rng):
    """A value string for option `o`, drawn from its type."""
    if o.type == "bool":
        return str(rng.choice(["yes", "no"]))
    if o.type == "int":
        lo, hi = int(o.minimum), int(o.maximum)
        return str(int(rng.integers(lo, hi + 1)) if hi > lo else
                   int(rng.integers(0, 8)))
    if o.type == "float":
        if o.maximum > o.minimum:
            v = rng.uniform(o.minimum, min(o.maximum, o.minimum + 50.0))
        else:
            v = rng.uniform(-2.0, 2.0)
        return repr(round(float(v), 4))
    return str(rng.choice(list(o.choices)))


def _plain(v):
    """An option value as plain data (enums by value)."""
    if isinstance(v, enum.Enum):
        return v.value
    if isinstance(v, tuple):
        return tuple(_plain(x) for x in v)
    return v


@pytest.mark.parametrize("key", [o.key for o in jopt.OPTION_TABLE()
                                 if o.type != "preset"])
def test_every_option_round_trips(key):
    """Each option set from a value of its type reads back the same in
    both packages, and the port's save() parses back to the same
    params."""
    o = topt.find_option(key)
    rng = np.random.default_rng(zlib.crc32(key.encode()))
    for _ in range(3):
        v = _sample(o, rng)
        jo, to = jopt.Options(), topt.Options()
        jo.set(key, v)
        to.set(key, v)
        assert _plain(to.get(key)) == _plain(jo.get(key))
        again = topt.Options()
        again.parse(to.save())
        assert again.save() == to.save()
        assert again.get(key) == to.get(key)


def test_save_strings_equal_on_random_combinations():
    """200 seeded combinations of 1-8 options (presets among them) set
    in both packages save to the same string."""
    rng = np.random.default_rng(1234)
    table = jopt.OPTION_TABLE()
    for _ in range(200):
        picks = rng.choice(len(table), size=int(rng.integers(1, 9)),
                           replace=False)
        jo, to = jopt.Options(), topt.Options()
        for i in picks:
            o = table[int(i)]
            v = _sample(o, rng)
            jo.set(o.key, v)
            to.set(o.key, v)
        assert to.save() == jo.save()


def _fields(p):
    """RenderParams fields as plain data (nested dataclasses and enums
    of either package compared by value)."""
    out = {}
    for f in dataclasses.fields(p):
        v = getattr(p, f.name)
        if dataclasses.is_dataclass(v):
            v = tuple(_plain(getattr(v, g.name))
                      for g in dataclasses.fields(v))
        out[f.name] = _plain(v)
    return out


def test_jax_saved_string_parses_to_equal_params():
    """Option strings saved by the JAX package parse in the port to a
    RenderParams whose fields equal the reference's."""
    rng = np.random.default_rng(77)
    table = jopt.OPTION_TABLE()
    strings = ["preset=high_quality,upscaler=ewa_lanczos,deband=yes",
               "preset=default,upscaler=ewa_lanczos,frame_mixer="
               "mitchell_clamp,tone_mapping=spline,gamut_mapping=perceptual"]
    for _ in range(50):
        jo = jopt.Options()
        for i in rng.choice(len(table), size=5, replace=False):
            jo.set(table[int(i)].key, _sample(table[int(i)], rng))
        strings.append(jo.save())
    for s in strings:
        jo, to = jopt.Options(), topt.Options()
        jo.parse(s)
        to.parse(s)
        assert _fields(to.params) == _fields(jo.params), s


def test_presets_equal():
    """The three presets, and the preset= pseudo-option, give equal
    fields; reset returns to the defaults."""
    for name in ("fast", "default", "high_quality"):
        jo, to = jopt.Options(), topt.Options()
        jo.set("preset", name)
        to.set("preset", name)
        assert _fields(to.params) == _fields(jo.params)
    for a, b in ((lt.FAST_PARAMS, jr.FAST_PARAMS),
                 (lt.DEFAULT_PARAMS, jr.DEFAULT_PARAMS),
                 (lt.HIGH_QUALITY_PARAMS, jr.HIGH_QUALITY_PARAMS)):
        assert _fields(a) == _fields(b)
    to = topt.Options()
    to.parse("deband=yes,upscaler=bicubic")
    to.reset()
    assert to.params == lt.DEFAULT_PARAMS and to.save() == ""
    assert [k for k, _ in to.iterate()] == \
        [k for k, _ in jopt.Options().iterate()]


@pytest.mark.parametrize("text", [
    "upscaler=not_a_filter", "no_such_option=1", "deband", "deband=maybe",
    "deband_iterations=two", "brightness=bright", "preset=ultra",
    "tone_mapping=nope"])
def test_parse_errors_have_the_same_class(text):
    with pytest.raises(Exception) as ej:
        jopt.Options().parse(text)
    with pytest.raises(Exception) as et:
        topt.Options().parse(text)
    assert type(et.value).__name__ == type(ej.value).__name__ == \
        "OptionError"
    assert issubclass(topt.OptionError, ValueError)


def test_user_shader_hooks_need_item_29():
    """mpv .hook text needs the GLSL translator: add_hook and
    insert_hook name the ROADMAP item; remove_hook_at works on hooks
    given as callables."""
    to = topt.Options()
    for call in (lambda: to.add_hook("//!HOOK MAIN\n"),
                 lambda: to.insert_hook(0, "//!HOOK MAIN\n")):
        with pytest.raises(NotImplementedError, match="slice 4 item 29"):
            call()
    h = lt.Hook(lt.HookStage.RGB, lambda img, p: img)
    to.params = dataclasses.replace(to.params, hooks=(h, h))
    to.remove_hook_at(0)
    assert to.params.hooks == (h,)


def test_log_levels_and_callback():
    """The log filters by level and routes to its callback as the
    reference's does."""
    for mod in (jlog, tlog):
        got = []
        lg = mod.log_create(mod.LogLevel.WARN,
                            lambda lvl, m: got.append((int(lvl), m)))
        lg.info("hidden")
        lg.warn("shown")
        lg.error("also")
        lg.update_level(mod.LogLevel.DEBUG)
        lg.debug("now shown")
        assert got[:2] == [(3, "shown"), (2, "also")]
        assert got[-1] == (5, "now shown")
    assert [lv.name for lv in tlog.LogLevel] == \
        [lv.name for lv in jlog.LogLevel]
    assert tlog.default_log().level == tlog.LogLevel.WARN

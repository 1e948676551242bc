"""mpv `.hook` user shaders on PyTorch.

Counterpart of libplacebo_tpu/render/mpv_hooks.py (the reference's
src/shaders/custom_mpv.c): the whole text format — //!HOOK/BIND/SAVE/
DESC/OFFSET/WIDTH/HEIGHT/WHEN/COMPONENTS/COMPUTE directives, RPN size
and condition expressions, //!TEXTURE blocks with hex payloads (STORAGE
images included), //!BUFFER blocks (std140 / std430), tunable //!PARAM
blocks and the stage names — parsed into passes, and a GLSL-subset
interpreter that runs each pass body as plain torch ops on the hooked
(C, H, W) tensor, on that tensor's device.

The interpreter keeps the JAX package's design value for value.  Every
value derived from image data is a torch tensor (the JAX package holds a
jax array there: anything read from a texture, builtin LUTs included);
values derived from sampling positions, invocation IDs and parameters
stay numpy arrays, numpy scalars or Python numbers, exactly where the
JAX package keeps them.  The type of a value decides between the static
and the per-pixel branch of an `if`, between a static gather and a
data-dependent LUT lookup, and what is rejected, so the port accepts,
runs and auto-disables the same shaders the JAX package does.

Sampling coordinates fall into the same three classes:

* affine in the output position (texOff constants, pos scaling):
  separable index_select gathers — the FSRCNNX convolution pattern;
* computed but position-derived (fract/floor of pos, invocation IDs):
  host index arrays, still static gathers;
* data-dependent into a bounded //!TEXTURE (the RAVU pattern): the
  table is indexed directly on the device with the bilinear weights the
  JAX package applies to its one-/two-hot matrices (the same products,
  summed in another order), within the same caps.

Data-dependent coordinates into image-sized textures are rejected and
the hook engine auto-disables the hook, as renderer.c:64-65 does.

The JAX package interprets a shader once per jit trace; this one
interprets it every frame.  What the host computes from positions and
parameters is therefore kept by the hook (`_Cache`): every numpy result
is memoized on its operands' identities, so a frame with the sizes and
parameters of an earlier one builds no host array and uploads none —
each host array crosses to the device once (as float32, int32 or bool,
as jnp.asarray does with x64 off) and is reused from then on.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .hooks import Hook, HookStage

__all__ = ["parse_user_shader", "user_shader_hook", "UserShader",
           "MpvHookError", "probe_recording"]


class MpvHookError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Stencil probing (multi-chip halo planning): while a probe record is
# active, texture accesses of non-builtin (image-derived) textures log
# their row-index patterns, and position materializations are flagged.
# ---------------------------------------------------------------------------

_PROBE: Optional[dict] = None


class probe_recording:
    """Context manager activating stencil probing into `rec`:
    rec["accesses"]: list of (pass_idx, row_indices, out_rows);
    rec["pos_value"]: True if a sampling position materialized into
    value arithmetic (position-dependent shader — not shard-shift
    invariant); rec["passes"]: executed pass count."""

    def __init__(self, rec: dict):
        rec.setdefault("accesses", [])
        rec.setdefault("pos_value", False)
        rec.setdefault("passes", 0)
        self.rec = rec

    def __enter__(self):
        global _PROBE
        self._prev = _PROBE
        _PROBE = self.rec
        return self.rec

    def __exit__(self, *exc):
        global _PROBE
        _PROBE = self._prev
        return False


# ---------------------------------------------------------------------------
# RPN size/condition expressions (reference parse_rpn_shexpr,
# custom_mpv.c:87-140)
# ---------------------------------------------------------------------------

def _parse_shexpr(line: str):
    """Tokenize an RPN expression; returns a list of (tag, value)."""
    out = []
    for word in line.split():
        if word.endswith(".w") or word.endswith(".width"):
            out.append(("tex_w", word.rsplit(".", 1)[0]))
        elif word.endswith(".h") or word.endswith(".height"):
            out.append(("tex_h", word.rsplit(".", 1)[0]))
        elif word in "+-*/%!":
            out.append(("op", word))
        elif word in (">", "<", "="):
            out.append(("op", word))
        elif word[0].isdigit():
            try:
                out.append(("const", float(word)))
            except ValueError:
                raise MpvHookError(f"bad shexpr constant: {word!r}")
        else:
            out.append(("var", word))
    return out


def _eval_shexpr(expr, sizes: Dict[str, Tuple[int, int]],
                 variables: Dict[str, float]) -> float:
    """Evaluate an RPN expression against texture sizes + PARAM values
    (reference pl_shexp evaluation)."""
    stack: List[float] = []
    for tag, val in expr:
        if tag == "const":
            stack.append(val)
        elif tag == "tex_w":
            if val not in sizes:
                raise MpvHookError(f"unknown texture {val!r} in shexpr")
            stack.append(float(sizes[val][1]))
        elif tag == "tex_h":
            if val not in sizes:
                raise MpvHookError(f"unknown texture {val!r} in shexpr")
            stack.append(float(sizes[val][0]))
        elif tag == "var":
            if val not in variables:
                raise MpvHookError(f"unknown variable {val!r} in shexpr")
            stack.append(float(variables[val]))
        elif tag == "op":
            if val == "!":
                if not stack:
                    raise MpvHookError("shexpr stack underflow")
                stack.append(0.0 if stack.pop() else 1.0)
                continue
            if len(stack) < 2:
                raise MpvHookError("shexpr stack underflow")
            b, a = stack.pop(), stack.pop()
            if val == "+":
                stack.append(a + b)
            elif val == "-":
                stack.append(a - b)
            elif val == "*":
                stack.append(a * b)
            elif val == "/":
                stack.append(a / b if b else 0.0)
            elif val == "%":
                stack.append(math.fmod(a, b) if b else 0.0)
            elif val == ">":
                stack.append(1.0 if a > b else 0.0)
            elif val == "<":
                stack.append(1.0 if a < b else 0.0)
            elif val == "=":
                stack.append(1.0 if abs(a - b) < 1e-6 * max(
                    abs(a), abs(b), 1.0) else 0.0)
    if len(stack) != 1:
        raise MpvHookError(f"shexpr leaves {len(stack)} values on stack")
    return stack[0]


# ---------------------------------------------------------------------------
# Data model (reference custom_shader_hook / pl_hook_par)
# ---------------------------------------------------------------------------

@dataclass
class ShaderPass:
    desc: str = "unknown user shader"
    hook_texs: List[str] = field(default_factory=list)
    bind_texs: List[str] = field(default_factory=list)
    save_tex: Optional[str] = None      # None = overwrite HOOKED
    body: str = ""
    offset: Tuple[float, float] = (0.0, 0.0)
    offset_align: bool = False
    components: int = 0                 # 0 = keep
    width: Optional[list] = None        # shexpr (None = HOOKED.w)
    height: Optional[list] = None
    cond: Optional[list] = None         # shexpr (None = true)
    is_compute: bool = False
    block_w: int = 0                    # pixels per workgroup
    block_h: int = 0
    threads_w: int = 0                  # actual threads (0 = block)
    threads_h: int = 0


@dataclass
class ShaderTexture:
    name: str
    data: np.ndarray                    # (H, W, comps) float32
    filter: str = "LINEAR"              # LINEAR | NEAREST
    border: str = "CLAMP"               # CLAMP | REPEAT | MIRROR
    # //!TEXTURE ... STORAGE (reference custom_mpv.c:444-450): a
    # read-write image, persistent across frames (PL_DESC_STORAGE_IMG),
    # written through imageStore(NAME, ...), read through imageLoad /
    # texture(); the renderer carries it in the hook's state
    storage: bool = False


@dataclass
class BufferVar:
    """One //!VAR declaration inside a //!BUFFER block."""
    name: str
    type: str                           # float|int|uint|bool|vecN|ivecN|matN
    dim_a: int = 0                      # 0 = not an array


@dataclass
class ShaderBuffer:
    """A //!BUFFER block (reference parse_buf, custom_mpv.c:500-616): a
    named uniform (read-only, std140) or STORAGE (read-write, std430)
    buffer whose //!VAR members become global identifiers in the hook
    bodies.  STORAGE writes (plain assignment of a spatially uniform
    value, or atomicAdd summed over the invocations) are visible to the
    later passes of the frame and, like the reference's persistent GPU
    buffer, carry across frames in the hook's state (Hook.state_spec);
    without the renderer's state channel they start over each frame."""
    name: str
    storage: bool = False
    vars: List[BufferVar] = field(default_factory=list)
    values: Dict[str, object] = field(default_factory=dict)


# GLSL scalar/vector/matrix sizes for buffer layout: type ->
# (components, column count) — matrices are column arrays
_BUF_TYPES = {
    "float": (1, 0), "int": (1, 0), "uint": (1, 0), "bool": (1, 0),
    "vec2": (2, 0), "vec3": (3, 0), "vec4": (4, 0),
    "ivec2": (2, 0), "ivec3": (3, 0), "ivec4": (4, 0),
    "uvec2": (2, 0), "uvec3": (3, 0), "uvec4": (4, 0),
    "bvec2": (2, 0), "bvec3": (3, 0), "bvec4": (4, 0),
    "mat2": (2, 2), "mat3": (3, 3), "mat4": (4, 4),
    "mat2x3": (3, 2), "mat3x2": (2, 3), "mat2x4": (4, 2),
    "mat4x2": (2, 4), "mat3x4": (4, 3), "mat4x3": (3, 4),
}


def _buf_align(comps: int, std430: bool) -> int:
    """Base alignment of a scalar/vecN in bytes (std140 == std430 for
    non-array, non-struct members: vec3 aligns like vec4)."""
    return 4 * {1: 1, 2: 2, 3: 4, 4: 4}[comps]


def _decode_buffer(vars: List[BufferVar], raw: bytes, std430: bool):
    """Decode the hex payload of a //!BUFFER per std140 (uniform) /
    std430 (storage) layout rules into {name: float | np.ndarray}.
    Empty payloads (legal for STORAGE) decode to zeros."""
    values: Dict[str, object] = {}
    off = 0
    zeros = len(raw) == 0
    for v in vars:
        if v.type not in _BUF_TYPES:
            raise MpvHookError(f"unsupported buffer var type {v.type!r}")
        comps, ncols = _BUF_TYPES[v.type]
        is_int = v.type[0] in "iub"     # int/uint/bool/ivec/uvec/bvec
        align = _buf_align(comps, std430)
        nelem = max(v.dim_a, 1) * max(ncols, 1)
        stride = align if std430 else max(align, 16)
        if v.dim_a == 0 and ncols == 0:
            # plain scalar/vector: natural alignment in both layouts
            off = (off + align - 1) // align * align
            if zeros:
                arr = np.zeros(comps, np.float32)
            else:
                dt = "<i4" if is_int else "<f4"
                arr = np.frombuffer(raw, dt, comps, off).astype(np.float64)
            off += comps * 4
            values[v.name] = float(arr[0]) if comps == 1 else \
                arr.astype(np.float32)
            continue
        # arrays and matrices: element stride rounds to 16 under std140
        off = (off + stride - 1) // stride * stride
        rows = []
        for _ in range(nelem):
            if zeros:
                rows.append(np.zeros(comps, np.float32))
            else:
                dt = "<i4" if is_int else "<f4"
                rows.append(np.frombuffer(raw, dt, comps, off)
                            .astype(np.float64).astype(np.float32))
            off += stride
        arr = np.stack(rows)
        if ncols and v.dim_a:
            arr = arr.reshape(v.dim_a, ncols, comps)
        values[v.name] = arr
    if not zeros and off > len(raw) + 3:
        raise MpvHookError(
            f"BUFFER payload too short: got {len(raw)}, need {off}")
    return values


@dataclass
class ShaderParam:
    """Reference pl_hook_par (custom_mpv.c:687)."""
    name: str
    description: str = ""
    mode: str = "variable"              # variable|dynamic|constant|define
    type: str = "float"
    default: float = 0.0
    minimum: float = -math.inf
    maximum: float = math.inf
    names: Tuple[str, ...] = ()         # ENUM values


@dataclass
class UserShader:
    passes: List[ShaderPass] = field(default_factory=list)
    textures: Dict[str, ShaderTexture] = field(default_factory=dict)
    params: Dict[str, ShaderParam] = field(default_factory=dict)
    buffers: Dict[str, ShaderBuffer] = field(default_factory=dict)
    name: str = "user shader"


# stage-name mapping (reference mp_stage_to_pl, custom_mpv.c:832-874)
_STAGE_MAP = {
    "RGB": HookStage.RGB_INPUT, "XYZ": HookStage.XYZ_INPUT,
    "LUMA": HookStage.LUMA_INPUT,
    "CHROMA": HookStage.CHROMA_INPUT, "ALPHA": HookStage.ALPHA_INPUT,
    "CHROMA_SCALED": HookStage.CHROMA_SCALED,
    "ALPHA_SCALED": HookStage.ALPHA_SCALED,
    "NATIVE": HookStage.NATIVE, "MAINPRESUB": HookStage.RGB,
    "MAIN": HookStage.RGB, "LINEAR": HookStage.LINEAR,
    "SIGMOID": HookStage.SIGMOID, "PREKERNEL": HookStage.PRE_KERNEL,
    "POSTKERNEL": HookStage.POST_KERNEL, "SCALED": HookStage.SCALED,
    "PREOUTPUT": HookStage.PRE_OUTPUT, "OUTPUT": HookStage.OUTPUT,
}
_STAGE_NAME = {v: k for k, v in _STAGE_MAP.items()}
_STAGE_NAME[HookStage.RGB] = "MAIN"


# ---------------------------------------------------------------------------
# Text parsing (reference parse_hook/parse_tex/parse_param,
# custom_mpv.c:152-300,305-500,687-830, pl_mpv_user_shader_parse :1594)
# ---------------------------------------------------------------------------

_TEX_FORMATS = {
    # name: (components, dtype, scale)
    "r8": (1, np.uint8, 255.0), "rg8": (2, np.uint8, 255.0),
    "rgb8": (3, np.uint8, 255.0), "rgba8": (4, np.uint8, 255.0),
    "r16": (1, np.dtype(">u2"), 65535.0),
    "rg16": (2, np.dtype(">u2"), 65535.0),
    "rgb16": (3, np.dtype(">u2"), 65535.0),
    "rgba16": (4, np.dtype(">u2"), 65535.0),
    "r16hf": (1, np.dtype("<f2"), 1.0), "rg16hf": (2, np.dtype("<f2"), 1.0),
    "rgb16hf": (3, np.dtype("<f2"), 1.0),
    "rgba16hf": (4, np.dtype("<f2"), 1.0),
    "r32f": (1, np.dtype("<f4"), 1.0), "rg32f": (2, np.dtype("<f4"), 1.0),
    "rgb32f": (3, np.dtype("<f4"), 1.0),
    "rgba32f": (4, np.dtype("<f4"), 1.0),
}


def parse_user_shader(text: str, name: str = "user shader") -> UserShader:
    """Parse a full mpv .hook file (reference pl_mpv_user_shader_parse,
    custom_mpv.c:1594)."""
    shader = UserShader(name=name)
    lines = text.split("\n")
    i = 0
    n = len(lines)

    def read_block_lines():
        """Consume //! directive lines starting at i."""
        nonlocal i
        dirs = []
        while i < n:
            stripped = lines[i].strip()
            if not stripped.startswith("//!"):
                break
            dirs.append(stripped[3:])
            i += 1
        return dirs

    def read_body():
        """Consume the body until the next //! line."""
        nonlocal i
        body = []
        while i < n and not lines[i].strip().startswith("//!"):
            body.append(lines[i])
            i += 1
        return "\n".join(body)

    while i < n:
        stripped = lines[i].strip()
        if not stripped.startswith("//!"):
            i += 1
            continue
        head = stripped[3:]
        if head.startswith("HOOK"):
            dirs = read_block_lines()
            p = ShaderPass()
            for d in dirs:
                key, _, rest = d.partition(" ")
                rest = rest.strip()
                if key == "HOOK":
                    if len(p.hook_texs) >= 16:
                        raise MpvHookError("too many HOOKs")
                    p.hook_texs.append(rest)
                elif key == "BIND":
                    p.bind_texs.append(rest)
                elif key == "SAVE":
                    p.save_tex = None if rest == "HOOKED" else (
                        "MAINPRESUB" if rest == "MAIN" else rest)
                    if p.save_tex is None:
                        p.save_tex = "HOOKED"
                elif key == "DESC":
                    p.desc = rest
                elif key == "OFFSET":
                    if rest == "ALIGN":
                        p.offset_align = True
                    else:
                        parts = rest.split()
                        if len(parts) != 2:
                            raise MpvHookError("Error while parsing OFFSET!")
                        p.offset = (float(parts[0]), float(parts[1]))
                elif key == "WIDTH":
                    p.width = _parse_shexpr(rest)
                elif key == "HEIGHT":
                    p.height = _parse_shexpr(rest)
                elif key == "WHEN":
                    p.cond = _parse_shexpr(rest)
                elif key == "COMPONENTS":
                    p.components = int(rest)
                elif key == "COMPUTE":
                    # reference custom_mpv.c:265-285: bw bh [tw th]
                    parts = rest.split()
                    if len(parts) not in (2, 4):
                        raise MpvHookError("Error while parsing COMPUTE!")
                    p.is_compute = True
                    p.block_w, p.block_h = int(parts[0]), int(parts[1])
                    if len(parts) == 4:
                        p.threads_w = int(parts[2])
                        p.threads_h = int(parts[3])
                    else:
                        p.threads_w, p.threads_h = p.block_w, p.block_h
                else:
                    raise MpvHookError(f"Unrecognized command {key!r}!")
            p.body = read_body()
            if not p.hook_texs:
                continue        # reference: warn + ignore
            shader.passes.append(p)
        elif head.startswith("TEXTURE"):
            dirs = read_block_lines()
            tname = dirs[0].partition(" ")[2].strip()
            size = None
            fmt = "rgba8"
            filt, border = "LINEAR", "CLAMP"
            storage = False
            for d in dirs[1:]:
                key, _, rest = d.partition(" ")
                rest = rest.strip()
                if key == "SIZE":
                    size = tuple(int(x) for x in rest.split())
                elif key == "FORMAT":
                    fmt = rest
                elif key == "FILTER":
                    filt = rest
                elif key == "BORDER":
                    border = rest
                elif key == "STORAGE":
                    storage = True
                else:
                    raise MpvHookError(f"bad TEXTURE directive {key!r}")
            payload = read_body().strip().replace("\n", "").replace(" ", "")
            if fmt not in _TEX_FORMATS:
                raise MpvHookError(f"unsupported texture format {fmt!r}")
            comps, dtype, scale = _TEX_FORMATS[fmt]
            raw = bytes.fromhex(payload)
            arr = np.frombuffer(raw, dtype=dtype).astype(np.float64) / scale
            if len(arr) == 0 and storage:
                # STORAGE textures may omit initial data (reference
                # custom_mpv.c:479-481) — zero-initialized
                if size is None:
                    raise MpvHookError(
                        f"STORAGE texture {tname}: no SIZE and no data")
                w = size[0]
                h = size[1] if len(size) > 1 else 1
                arr = np.zeros(w * h * comps, np.float64)
            if size is None:
                size = (len(arr) // comps, 1)   # width, height=1
            w = size[0]
            h = size[1] if len(size) > 1 else 1
            if len(arr) != w * h * comps:
                raise MpvHookError(
                    f"texture {tname}: payload {len(arr)} != "
                    f"{w}x{h}x{comps}")
            data = arr.reshape(h, w, comps).astype(np.float32)
            shader.textures[tname] = ShaderTexture(
                name=tname, data=data, filter=filt, border=border,
                storage=storage)
        elif head.startswith("BUFFER"):
            dirs = read_block_lines()
            buf = ShaderBuffer(name=dirs[0].partition(" ")[2].strip())
            for d in dirs[1:]:
                key, _, rest = d.partition(" ")
                rest = rest.strip()
                if key == "BUFFER":
                    buf.name = rest
                elif key == "STORAGE":
                    buf.storage = True
                elif key == "VAR":
                    vtype, _, vname = rest.partition(" ")
                    vname = vname.strip()
                    dim = 0
                    if "[" in vname:
                        vname, _, dpart = vname.partition("[")
                        dim = int(dpart.rstrip("]").strip())
                        if dim < 1:
                            raise MpvHookError(
                                f"invalid array dimension {dim}")
                    buf.vars.append(BufferVar(name=vname.strip(),
                                              type=vtype.strip(),
                                              dim_a=dim))
                else:
                    raise MpvHookError(f"bad BUFFER directive {key!r}")
            payload = read_body().strip().replace("\n", "").replace(" ", "")
            raw = bytes.fromhex(payload)
            if raw and not buf.storage and not buf.vars:
                raise MpvHookError(f"BUFFER {buf.name}: data but no VARs")
            buf.values = _decode_buffer(buf.vars, raw, std430=buf.storage)
            shader.buffers[buf.name] = buf
        elif head.startswith("PARAM"):
            dirs = read_block_lines()
            pname = dirs[0].partition(" ")[2].strip()
            par = ShaderParam(name=pname)
            for d in dirs[1:]:
                key, _, rest = d.partition(" ")
                rest = rest.strip()
                if key == "DESC":
                    par.description = rest
                elif key == "MINIMUM":
                    par.minimum = float(rest)
                elif key == "MAXIMUM":
                    par.maximum = float(rest)
                elif key == "TYPE":
                    words = rest.split()
                    is_enum = words and words[0] == "ENUM"
                    if is_enum:
                        words = words[1:]
                    mode = "variable"
                    if words and words[0] in ("DYNAMIC", "CONSTANT",
                                              "DEFINE"):
                        mode = words[0].lower()
                        words = words[1:]
                    par.mode = mode
                    par.type = words[0] if words else (
                        "int" if mode == "define" else "float")
                    if is_enum:
                        par.type = "enum"
                else:
                    raise MpvHookError(f"bad PARAM directive {key!r}")
            body = read_body()
            vals = [ln.strip() for ln in body.split("\n") if ln.strip()]
            if par.type == "enum":
                # every line names an enum value; the first is the default
                par.names = tuple(vals)
                par.default = 0.0
            elif vals:
                par.default = float(vals[0])
            par.default = min(max(par.default, par.minimum), par.maximum)
            shader.params[pname] = par
        else:
            i += 1
    return shader


# ---------------------------------------------------------------------------
# GLSL body translation
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(r"""
    (?P<num>\d+\.\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|\d+([eE][+-]?\d+)?u?)
  | (?P<id>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op>\+\+|--|\+=|-=|\*=|/=|<=|>=|==|!=|&&|\|\||[+\-*/%(),.;=?:!<>{}\[\]])
""", re.VERBOSE)


def _tokenize(src: str) -> List[str]:
    src = re.sub(r"/\*.*?\*/", " ", src, flags=re.S)
    src = re.sub(r"//[^\n]*", " ", src)
    toks = []
    pos = 0
    while pos < len(src):
        if src[pos].isspace():
            pos += 1
            continue
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise MpvHookError(f"GLSL tokenize error at {src[pos:pos+20]!r}")
        toks.append(m.group(0))
        pos = m.end()
    return toks


class _Pos:
    """Symbolic sampling position: an affine transform of a texture's
    normalized coordinates — keeps sampling coordinates statically
    resolvable.  Non-affine operations (fract, swizzles, comparisons …)
    materialize the position into per-pixel host coordinate arrays;
    only values derived from the image become tensors."""
    __slots__ = ("base", "scale", "offset")

    def __init__(self, base, scale=(1.0, 1.0), offset=(0.0, 0.0)):
        self.base = base
        self.scale = scale
        self.offset = offset


def _is_traced(x) -> bool:
    """True for any torch tensor — a value whose provenance is the image
    data (the JAX package's jax arrays).  Position- and parameter-derived
    chains stay numpy or Python throughout the interpreter."""
    return isinstance(x, torch.Tensor)


# ---------------------------------------------------------------------------
# Host values and their crossings to the device
# ---------------------------------------------------------------------------

def _hkey(x):
    """Memo key of an operand: host arrays by identity (the cache holds
    them, so an identity is never reused while it is a key), numbers by
    type and value."""
    if isinstance(x, np.ndarray):
        return ("a", id(x))
    if isinstance(x, (tuple, list)):
        return ("t",) + tuple(_hkey(e) for e in x)
    if x is None:
        return ("n",)
    return (type(x).__name__, repr(x))


class _Cache:
    """What a hook computes on the host from positions, invocation IDs,
    sizes and parameters, kept across frames: numpy results memoized on
    their operands' identities and values, and each host array's device
    copy.  A frame with the sizes and parameters of an earlier one makes
    no host array and no upload (`uploads` counts the crossings).  Past
    CAP entries a memo starts over."""

    CAP = 65536

    def __init__(self):
        self.host: Dict[tuple, tuple] = {}
        self.dev: Dict[tuple, tuple] = {}
        self.uploads = 0

    def memo(self, name, fn, *args):
        key = (name,) + tuple(_hkey(a) for a in args)
        hit = self.host.get(key)
        if hit is not None:
            return hit[0]
        val = fn(*args)
        if len(self.host) >= self.CAP:
            self.host.clear()
        self.host[key] = (val, args)      # the operands kept alive
        return val

    def upload(self, key, keep, make):
        """The device tensor `make()` builds from host data, built once
        for `key` (which names the host objects by identity; `keep`
        holds them, so no identity in a live key is reused)."""
        hit = self.dev.get(key)
        if hit is None:
            if len(self.dev) >= self.CAP:
                self.dev.clear()
            hit = (make(), keep)
            self.dev[key] = hit
            self.uploads += 1
        return hit[0]


_HOST_BIN = {
    "+": lambda x, y: x + y, "-": lambda x, y: x - y,
    "*": lambda x, y: x * y, "/": lambda x, y: x / y,
    "<": lambda x, y: x < y, ">": lambda x, y: x > y,
    "<=": lambda x, y: x <= y, ">=": lambda x, y: x >= y,
    "==": lambda x, y: x == y, "!=": lambda x, y: x != y,
    "&": lambda x, y: x & y, "|": lambda x, y: x | y,
}


class _HostOps:
    """numpy's functions, memoized in the hook's cache (what `_amod`
    hands out while no operand is a tensor)."""

    def __init__(self, cache: _Cache):
        self._cache = cache

    def __getattr__(self, name):
        fn = getattr(np, name)
        cache = self._cache

        def call(*args):
            return cache.memo(name, fn, *args)
        return call


class _Ops:
    """The interpreter's arithmetic on a mix of tensors, host arrays and
    numbers, on one device.  While no operand is a tensor the work is
    numpy's (memoized); once one is, host operands cross to the device
    as jnp.asarray would take them with x64 off: float arrays as
    float32, integer arrays as int32, bool as bool, numpy scalars as
    Python numbers."""

    def __init__(self, device, cache: _Cache):
        self.device = torch.device(device)
        self.cache = cache
        self.host = _HostOps(cache)
        self._consts: Dict[tuple, torch.Tensor] = {}

    # -- crossings -------------------------------------------------------

    def dev(self, x):
        """`x` as the device would take it: tensors as they are, numpy
        scalars and 0-d arrays as Python numbers, arrays as tensors."""
        if isinstance(x, torch.Tensor):
            return x
        if isinstance(x, np.generic) or (isinstance(x, np.ndarray)
                                         and x.ndim == 0):
            return x.item()
        if isinstance(x, np.ndarray):
            return self.cache.upload(("dev", self.device, id(x)), x,
                                     lambda: self._to_tensor(x))
        return x

    def _to_tensor(self, a: np.ndarray) -> torch.Tensor:
        if a.dtype == np.bool_:
            host = np.array(a)
        elif np.issubdtype(a.dtype, np.integer):
            host = np.array(a, np.int32)
        else:
            host = np.array(a, np.float32)
        return torch.from_numpy(host).to(self.device)

    def index(self, a: np.ndarray) -> torch.Tensor:
        """A host index array as an int64 tensor on the device, once."""
        return self.cache.upload(("idx", self.device, id(a)), a,
                                 lambda: torch.from_numpy(
                                     np.array(a, np.int64)).to(self.device))

    def const(self, value: float, shape) -> torch.Tensor:
        """A float32 tensor of `shape` holding `value`: one stored 0-d
        tensor expanded (no copy; nothing writes into it)."""
        key = float(value)
        t = self._consts.get(key)
        if t is None:
            t = torch.full((), key, dtype=torch.float32, device=self.device)
            self._consts[key] = t
        return t.expand(tuple(shape))

    def plane(self, c, H, W) -> torch.Tensor:
        """A component as an (H, W) float32 tensor (a uniform value
        broadcast to the grid)."""
        if hasattr(c, "shape"):
            t = self.dev(c)
            if isinstance(t, torch.Tensor):
                return t.to(torch.float32).expand(H, W)
            c = t
        return self.const(float(c), (H, W))

    # -- arithmetic --------------------------------------------------------

    def am(self, *xs):
        """The array module for an operand mix (the JAX package's _amod):
        the device's once any operand is image data, else numpy's."""
        if any(isinstance(x, torch.Tensor) for x in xs):
            return _DevOps(self)
        return self.host

    def arith(self, op, x, y):
        """x <op> y for Python, numpy or tensor operands."""
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            return _HOST_BIN[op](self.dev(x), self.dev(y))
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            return self.cache.memo(op, _HOST_BIN[op], x, y)
        return _HOST_BIN[op](x, y)

    def neg(self, c):
        if isinstance(c, np.ndarray):
            return self.cache.memo("neg", np.negative, c)
        return -c

    def invert(self, c):
        """`!c`: ~ on arrays and tensors, `not` on numbers."""
        if isinstance(c, np.ndarray):
            return self.cache.memo("invert", np.invert, c)
        return ~c if hasattr(c, "shape") else (not c)

    def total(self, vals):
        """vals[0] + vals[1] + ... (Python's sum without its leading 0)."""
        acc = vals[0]
        for v in vals[1:]:
            acc = self.arith("+", acc, v)
        return acc


class _DevOps:
    """numpy's names for the torch ops the interpreter uses, on operand
    mixes holding a tensor; host operands cross first (_Ops.dev)."""

    def __init__(self, ops: _Ops):
        self._ops = ops

    def _t(self, x):
        """`x` as a tensor: a number becomes a stored 0-d float32 tensor
        (broadcast by the op; no upload)."""
        x = self._ops.dev(x)
        if isinstance(x, torch.Tensor):
            return x
        return self._ops.const(float(x), ())

    def where(self, c, x, y):
        """torch.where with a tensor result even for a host condition
        (jnp.where's is a device array too); a non-bool condition tests
        != 0, as jnp.where does."""
        c, x, y = self._t(c), self._ops.dev(x), self._ops.dev(y)
        if c.dtype != torch.bool:
            c = c != 0
        if not isinstance(x, torch.Tensor) and \
                not isinstance(y, torch.Tensor):
            x = self._t(x)
        return torch.where(c, x, y)

    def mod(self, x, y):
        return torch.remainder(self._t(x), self._ops.dev(y))

    def logical_not(self, x):
        return torch.logical_not(self._ops.dev(x))

    def logical_and(self, x, y):
        return torch.logical_and(self._t(x), self._t(y))

    def logical_or(self, x, y):
        return torch.logical_or(self._t(x), self._t(y))

    def _unary(name):
        def f(self, x):
            return getattr(torch, name)(self._ops.dev(x))
        return f

    trunc = _unary("trunc")
    floor = _unary("floor")
    ceil = _unary("ceil")
    sqrt = _unary("sqrt")
    abs = _unary("abs")
    exp = _unary("exp")
    exp2 = _unary("exp2")
    log = _unary("log")
    log2 = _unary("log2")
    sign = _unary("sign")
    sin = _unary("sin")
    cos = _unary("cos")
    tan = _unary("tan")
    arcsin = _unary("asin")
    arccos = _unary("acos")
    arctan = _unary("atan")
    round = _unary("round")
    del _unary

    def clip(self, x, lo, hi):
        return torch.clamp(self._ops.dev(x), lo, hi)

    def minimum(self, x, y):
        return torch.minimum(self._t(x), self._t(y))

    def maximum(self, x, y):
        return torch.maximum(self._t(x), self._t(y))

    def power(self, x, y):
        return torch.pow(self._t(x), self._ops.dev(y))

    def arctan2(self, y, x):
        return torch.atan2(self._t(y), self._t(x))

    def broadcast_to(self, x, shape):
        return self._ops.dev(x).expand(tuple(shape))

    def sum(self, x):
        return self._ops.dev(x).sum()


class _Vec:
    """A GLSL value: list of per-pixel components (tensors, host arrays
    or Python numbers).  A scalar is a 1-component _Vec with
    scalar=True."""
    __slots__ = ("comps", "scalar")

    def __init__(self, comps, scalar=False):
        self.comps = list(comps)
        self.scalar = scalar and len(self.comps) == 1

    def __len__(self):
        return len(self.comps)


_SWIZ = {"x": 0, "y": 1, "z": 2, "w": 3,
         "r": 0, "g": 1, "b": 2, "a": 3,
         "s": 0, "t": 1, "p": 2, "q": 3}


def _expand_defines(body: str, max_rounds: int = 16) -> str:
    """Expand #define macros: object-like AND simple function-like
    (naive textual argument substitution, like the C preprocessor
    without stringize/paste). Community hooks rely heavily on
    `#define get(off) HOOKED_texOff(off)`-style helpers."""
    obj: Dict[str, str] = {}
    funcs: Dict[str, Tuple[List[str], str]] = {}
    out_lines = []
    for line in body.split("\n"):
        m = re.match(r"\s*#define\s+(\w+)\(([^)]*)\)\s+(.*)$", line)
        if m:
            args = [a.strip() for a in m.group(2).split(",") if a.strip()]
            funcs[m.group(1)] = (args, m.group(3).strip())
            continue
        m = re.match(r"\s*#define\s+(\w+)\s+(.*)$", line)
        if m:
            obj[m.group(1)] = m.group(2).strip()
            continue
        out_lines.append(line)
    body = "\n".join(out_lines)

    def expand_call(text, name, params, repl):
        """Expand one function-like macro occurrence at a time."""
        pat = re.compile(rf"\b{re.escape(name)}\s*\(")
        while True:
            m = pat.search(text)
            if not m:
                return text
            # find matching close paren + split top-level args
            depth, j = 1, m.end()
            arg_starts = [m.end()]
            args = []
            while j < len(text) and depth:
                c = text[j]
                if c == "(":
                    depth += 1
                elif c == ")":
                    depth -= 1
                    if depth == 0:
                        args.append(text[arg_starts[-1]:j].strip())
                elif c == "," and depth == 1:
                    args.append(text[arg_starts[-1]:j].strip())
                    arg_starts.append(j + 1)
                j += 1
            if depth:
                raise MpvHookError(f"unbalanced parens in {name} call")
            exp = repl
            for pn, av in zip(params, args):
                # (?<!\.) — a parameter named like a swizzle component
                # must not replace `.x` field accesses in the body
                # (the classic `#define L(x, y) tex(vec2(x, y)).x`)
                exp = re.sub(rf"(?<!\.)\b{re.escape(pn)}\b",
                             f"({av})", exp)
            text = text[:m.start()] + "(" + exp + ")" + text[j:]

    for _ in range(max_rounds):
        before = body
        for name, val in obj.items():
            body = re.sub(rf"(?<!\.)\b{re.escape(name)}\b",
                          f"({val})", body)
        for name, (params, repl) in funcs.items():
            body = expand_call(body, name, params, repl)
        if body == before:
            break
    return body


def _prepare_body(body: str, defines, compute: bool):
    """A pass body's tokens inside its entry point, after the PARAM/enum
    defines and the #define macros are expanded, and (compute passes)
    its workgroup-shared array declarations as (name, type) pairs, taken
    out of the text (replayed on demand, never materialized).  A pure
    function of the text, made once a hook."""
    for k, v in defines:
        body = re.sub(rf"(?<!\.)\b{re.escape(k)}\b", v, body)
    body = _expand_defines(body)
    if re.search(r"^\s*#", body, re.M):
        raise MpvHookError("unsupported preprocessor directive")
    shared = ()
    if compute:
        shared = tuple((sm.group(2), sm.group(1)) for sm in re.finditer(
            r"\bshared\s+(float|int|uint|vec2|vec3|vec4)\s+"
            r"(\w+)\s*\[[^\]]*\]\s*;", body))
        body = re.sub(r"\bshared\s+[^;]*;", " ", body)
        m = re.search(r"(?:void|vec4)\s+hook\s*\(\s*\)\s*{", body)
    else:
        m = re.search(r"vec4\s+hook\s*\(\s*\)\s*{", body)
    if not m:
        raise MpvHookError("no `vec4 hook()` entry point found")
    depth = 1
    j = m.end()
    while j < len(body) and depth:
        if body[j] == "{":
            depth += 1
        elif body[j] == "}":
            depth -= 1
        j += 1
    return tuple(_tokenize(body[m.end():j - 1])), shared


# sentinel for a bare `return;` inside a compute `void hook()`
_VOID_RETURN = object()


class _BodyRunner:
    """Executes a restricted-GLSL `vec4 hook()` body on tensors.

    Compute hooks (`//!COMPUTE`, reference custom_mpv.c:265-285,1482-1503)
    run the same interpreter in compute mode: one invocation per output
    pixel, `gl_*InvocationID`/`gl_WorkGroup*` bound to host coordinate
    grids (position-derived, so sampling stays a static gather), output
    assembled from `imageStore(out_image, ...)` calls, `barrier()` a
    no-op.  Workgroup-shared arrays are handled by transparent replay:
    the canonical cooperative-fill loop

        for (uint id = gl_LocalInvocationIndex; id < N; id += wg_size)
            cache[id] = <pure function of id and gl_WorkGroupID>;

    is captured (not executed), and every later `cache[idx]` read
    re-evaluates the fill body with `id := idx` — exact, since each slot
    is written once as a pure function of its index and the barrier only
    publishes it — so the shared tile is never materialized and each
    read is the same separable static gather as a fragment texOff tap."""

    def __init__(self, textures: Dict[str, "_TexView"],
                 hooked: str, params: Dict[str, float],
                 defines: Dict[str, str], out_shape: Tuple[int, int],
                 ops: _Ops,
                 buf_vals: Optional[Dict[str, object]] = None,
                 buf_writable: Optional[set] = None,
                 compute: Optional[Tuple[int, int]] = None,
                 stex: Optional[Dict[str, object]] = None,
                 block: Optional[Tuple[int, int]] = None):
        self.tex = textures
        self.hooked = hooked
        self.params = params
        self.defines = defines
        self.ops = ops
        self.out_h, self.out_w = out_shape
        self.H, self.W = out_shape
        if compute is not None and block is not None and \
                block != compute:
            # 4-arg //!COMPUTE (reference custom_mpv.c:265-285): each
            # bw x bh pixel block is covered by tw x th threads — an
            # invocation handles several pixels.  The grid is the THREAD
            # grid (full workgroups, like the reference's DIV_UP
            # dispatch); imageStore scatters onto the (out_h, out_w)
            # image
            tw, th = compute
            bw, bh = block
            self.W = -(-out_shape[1] // bw) * tw
            self.H = -(-out_shape[0] // bh) * th
        # //!BUFFER members: flat GLSL-style global namespace
        self.buf_vals = buf_vals or {}
        self.buf_writable = buf_writable or set()
        self.compute = compute          # (threads_w, threads_h) or None
        self.shared: Dict[str, dict] = {}
        # //!TEXTURE ... STORAGE images: current (C, h, w) values,
        # writable through imageStore(NAME, ...) from any pass kind,
        # readable through imageLoad/texture(); the final values land in
        # self.stex_writes after run()
        self.stex = stex or {}
        self._stex_stores: Dict[str, list] = {}
        self.stex_writes: Dict[str, object] = {}
        # append-only log of atomicAdd targets, the members exempt from
        # if/else where-merging: _if_stmt detects "added inside THIS
        # branch" from its length (a set delta misses a repeated add on a
        # member added earlier in the pass)
        self._atomic_log: list = []

    def _amod(self, *xs):
        return self.ops.am(*xs)

    # -- value helpers ---------------------------------------------------

    def _broadcast(self, a: _Vec, b: _Vec) -> Tuple[_Vec, _Vec]:
        if len(a) == len(b):
            return a, b
        if a.scalar:
            return _Vec(a.comps * len(b)), b
        if b.scalar:
            return a, _Vec(b.comps * len(a))
        raise MpvHookError(f"size mismatch: vec{len(a)} vs vec{len(b)}")

    def _binop(self, op, a: _Vec, b: _Vec) -> _Vec:
        a = self._materialize(a)
        b = self._materialize(b)
        a, b = self._broadcast(a, b)
        ops = self.ops

        def f(x, y):
            if op == "%":
                return self._amod(x, y).mod(x, y) \
                    if hasattr(x, "shape") or hasattr(y, "shape") \
                    else math.fmod(x, y)
            if op in ("&&", "||"):
                if hasattr(x, "shape") or hasattr(y, "shape"):
                    return ops.arith("&" if op == "&&" else "|", x, y)
                return (bool(x) and bool(y)) if op == "&&" else \
                    (bool(x) or bool(y))
            return ops.arith(op, x, y)
        return _Vec([f(x, y) for x, y in zip(a.comps, b.comps)],
                    scalar=a.scalar and b.scalar)

    # -- statements --------------------------------------------------------

    def run(self, body: str):
        toks, shared = self.ops.cache.memo(
            "tokens", _prepare_body, body,
            tuple(sorted(self.defines.items())), self.compute is not None)
        self.toks = toks
        self.shared = {name: {"type": t} for name, t in shared}
        self.pos = 0
        self.vars: Dict[str, _Vec] = {}
        self.arrays: Dict[str, List[_Vec]] = {}
        # early-return predication: _mask_stack holds the active
        # per-pixel path conditions (one per enclosing traced if-branch);
        # _pending_rets collects (mask, vec4) for lanes that returned
        # early, merged first-return-wins at the end of run()
        self._mask_stack: List[object] = []
        self._pending_rets: List[tuple] = []
        # compute mode: recorded imageStores, captured shared fill loops
        # and the "returned early" lane mask
        self._image_stores: List[tuple] = []
        self._shared_fill: Dict[str, tuple] = {}
        self._replay: Optional[dict] = None
        self._dead = None
        if self.compute is not None:
            self._bind_invocation_vars()
        # //!BUFFER members enter as pre-bound globals (locals may
        # shadow by declaration, matching GLSL scoping)
        self._buf_names = set()
        for bname, val in self.buf_vals.items():
            self._buf_names.add(bname)
            if isinstance(val, list):
                self.arrays[bname] = [
                    v if isinstance(v, _Vec) else
                    _Vec(list(np.atleast_1d(v)), scalar=np.ndim(v) == 0)
                    for v in val]
            elif isinstance(val, np.ndarray) and val.ndim >= 2:
                self.arrays[bname] = [_Vec(list(row)) for row in val]
            elif isinstance(val, np.ndarray) and val.ndim == 1:
                self.vars[bname] = _Vec(list(val), scalar=val.size == 1)
            elif isinstance(val, _Vec):
                self.vars[bname] = val
            else:
                self.vars[bname] = _Vec([val], scalar=True)
        if _PROBE is not None:
            _PROBE["passes"] += 1
        ret = self._run_statements()
        if self.compute is not None:
            if ret is not None and ret is not _VOID_RETURN:
                raise MpvHookError("compute hook() must return void")
            ret = self._assemble_stores()
            self._collect_buf_writes()
            self._collect_stex_writes()
            return ret
        if ret is None and self._pending_rets:
            # every lane returned through conditional paths (an if/else
            # whose branches both return).  GLSL leaves lanes no return
            # covers undefined; they take the LAST conditional return's
            # value, exact for the common fully-covered patterns
            _, ret = self._pending_rets.pop()
        if ret is None:
            raise MpvHookError("hook() did not return")
        # merge early returns (first return wins, so apply in reverse)
        for mask, val in reversed(self._pending_rets):
            a, b = self._broadcast(val, ret)
            ret = _Vec([self._amod(mask, x, y).where(mask, x, y)
                        for x, y in zip(a.comps, b.comps)],
                       scalar=a.scalar)
        self._pending_rets = []
        self._collect_buf_writes()
        self._collect_stex_writes()
        return ret

    def _collect_buf_writes(self):
        """Collect final values of writable (STORAGE) buffer members."""
        self.buf_writes: Dict[str, object] = {}
        for bname in self._buf_names & self.buf_writable:
            if bname in self.arrays:
                self.buf_writes[bname] = self.arrays[bname]
            else:
                v = self.vars[bname]
                for c in v.comps:
                    if hasattr(c, "shape") and int(np.prod(c.shape)) > 1:
                        raise MpvHookError(
                            f"storage var {bname!r} assigned a per-pixel "
                            "value (a data race in GLSL too) — reduce it "
                            "first or use atomicAdd")
                self.buf_writes[bname] = v

    # -- compute-mode machinery -------------------------------------------

    def _bind_invocation_vars(self):
        """Bind the GLSL compute built-ins as host coordinate grids (one
        invocation per output pixel; x kept (1, W)-shaped and y
        (H, 1)-shaped so derived sampling coords stay separable), made
        once per grid and workgroup size."""
        tw, th = self.compute

        def grids(W, H, tw, th):
            X = np.arange(W, dtype=np.float64)[None, :]
            Y = np.arange(H, dtype=np.float64)[:, None]
            return {
                "gl_GlobalInvocationID": [X, Y, 0.0],
                "gl_LocalInvocationID": [X % tw, Y % th, 0.0],
                "gl_WorkGroupID": [X // tw, Y // th, 0.0],
                "gl_WorkGroupSize": [float(tw), float(th), 1.0],
                "gl_NumWorkGroups": [float(-(-W // tw)),
                                     float(-(-H // th)), 1.0],
                "gl_LocalInvocationIndex": [(Y % th) * tw + (X % tw)]}
        for name, comps in self.ops.cache.memo(
                "invocation", grids, self.W, self.H, tw, th).items():
            self.vars[name] = _Vec(comps, scalar=len(comps) == 1)

    def _capture_shared_fill(self, var):
        """Capture (don't execute) a cooperative shared-fill loop whose
        start depends on the invocation; called by _for_stmt after the
        init expression.  Records the body span for replay keyed by
        every shared array the body assigns."""
        cvar = self._next()
        if cvar != var:
            raise MpvHookError("for-loop condition must test the "
                               "loop var")
        self._next()                              # comparison op
        self._expr()                              # bound (ignored)
        self._expect(";")
        ivar = self._next()
        if ivar != var:
            raise MpvHookError("for-loop increment must update the "
                               "loop var")
        itok = self._next()
        if itok in ("+=", "-="):
            self._expr()
        elif itok not in ("++", "--"):
            raise MpvHookError(f"unsupported loop increment {itok!r}")
        self._expect(")")
        start = self.pos
        self._skip_block()
        end = self.pos
        wrote = set()
        k = start
        while k < end - 1:
            if self.toks[k] in self.shared and self.toks[k + 1] == "[":
                d, j = 1, k + 2
                while j < end and d:
                    if self.toks[j] == "[":
                        d += 1
                    elif self.toks[j] == "]":
                        d -= 1
                    j += 1
                if j < end and self.toks[j] == "=" and \
                        self.toks[j + 1] != "=":
                    wrote.add(self.toks[k])
            k += 1
        if not wrote:
            raise MpvHookError(
                "a for loop with invocation-dependent bounds must be a "
                "cooperative shared-array fill")
        for nm in wrote:
            self._shared_fill[nm] = (var, start, end)

    def _shared_read(self, name, idxv):
        """Read shared[idx] by replaying the captured fill body with the
        loop variable bound to idx (see class docstring)."""
        spec = self._shared_fill.get(name)
        if spec is None:
            raise MpvHookError(
                f"shared array {name!r} read before its fill loop")
        ridx = idxv.comps[0]
        if _is_traced(ridx):
            raise MpvHookError(
                "data-dependent shared-memory indices are not supported "
                "(per-pixel gather); indices must derive from "
                "invocation IDs / constants")
        var, start, end = spec
        saved = (self.pos, dict(self.vars),
                 {k: list(v) for k, v in self.arrays.items()},
                 self._replay)
        self._replay = {"target": name, "idx": ridx, "value": None}
        self.vars[var] = _Vec([ridx], scalar=True)
        self.pos = start
        try:
            if self._run_block() is not None:
                raise MpvHookError("return inside a fill loop is "
                                   "unsupported")
            val = self._replay["value"]
        finally:
            self.pos, self.vars, self.arrays, self._replay = saved
        if val is None:
            raise MpvHookError(
                f"fill loop never assigned {name}[{var}]")
        return val

    def _shared_write(self, name):
        """`name[idx] = expr;` with name a shared array: outside replay
        this must be inside a captured fill loop (never reached —
        capture skips the body); during replay of `name`, record the
        value when the write index matches the requested slot."""
        self._next()
        self._expect("[")
        idxv = self._materialize(self._expr())
        self._expect("]")
        op = self._next()
        if op != "=":
            raise MpvHookError(
                f"shared arrays support only plain assignment, got "
                f"{op!r}")
        val = self._expr()
        self._expect(";")
        rp = self._replay
        if rp is None:
            raise MpvHookError(
                "shared-array writes must occur inside a cooperative "
                "fill loop (for (id = <invocation>; id < N; id += S))")
        if rp["target"] != name:
            return None                 # other array's fill: skip
        if _is_traced(idxv.comps[0]):
            raise MpvHookError(
                f"data-dependent write index into shared {name!r}")

        def same_slot(wi, ri):
            try:
                return np.array_equal(*np.broadcast_arrays(
                    np.asarray(wi), np.asarray(ri)))
            except ValueError:
                return False
        if not self.ops.cache.memo("same_slot", same_slot, idxv.comps[0],
                                   rp["idx"]):
            raise MpvHookError(
                f"fill loop writes {name!r} at an index other than the "
                "loop variable — pattern too complex to replay")
        rp["value"] = val
        return None

    def _image_store(self):
        """imageStore(out_image | STORAGE tex, ivec2 pos, vec4 val) —
        recorded, then assembled at the end of run(): out_image stores
        become the pass output; STORAGE-texture stores update the
        persistent image read-modify-write (reference
        PL_DESC_STORAGE_IMG, custom_mpv.c:444-450)."""
        self._expect("(")
        name = self._next()
        if name != "out_image" and name not in self.stex:
            raise MpvHookError(
                f"imageStore target must be out_image or a //!TEXTURE "
                f"STORAGE image, got {name!r}")
        if name == "out_image" and self.compute is None:
            raise MpvHookError("imageStore(out_image, ...) outside a "
                               "compute hook")
        self._expect(",")
        pos = self._materialize(self._expr())
        self._expect(",")
        val = self._materialize(self._expr())
        self._expect(")")
        if len(pos) < 2:
            raise MpvHookError("imageStore position must be an ivec2")
        px, py = pos.comps[0], pos.comps[1]
        if _is_traced(px) or _is_traced(py):
            raise MpvHookError(
                "data-dependent imageStore coordinates are not "
                "supported (per-pixel scatter)")
        mask = self._dead if self._dead is None else self._amod(
            self._dead).logical_not(self._dead)
        for m in self._mask_stack:
            mask = m if mask is None else self._amod(mask, m).logical_and(
                mask, m)
        rec = (mask, self.ops.host.asarray(px, np.float64),
               self.ops.host.asarray(py, np.float64), self._to_vec4(val))
        if name == "out_image":
            self._image_stores.append(rec)
        else:
            self._stex_stores.setdefault(name, []).append(rec)

    def _store_plan(self, px, py, mask, th, tw):
        """The host side of one imageStore onto a (th, tw) target, made
        once per grid: ("own", None) when every invocation stores at its
        own pixel, else ("scatter", (flat selection, rows, columns)) of
        the in-bounds (and, for a host mask, live) invocations."""
        H, W = self.H, self.W

        def plan(px, py, mask, th, tw, H, W):
            pxb = np.broadcast_to(px, (H, W)).astype(np.int64)
            pyb = np.broadcast_to(py, (H, W)).astype(np.int64)
            if (th, tw) == (H, W) and \
                    np.array_equal(pxb, np.broadcast_to(
                        np.arange(W, dtype=np.int64)[None, :], (H, W))) \
                    and np.array_equal(pyb, np.broadcast_to(
                        np.arange(H, dtype=np.int64)[:, None], (H, W))):
                return "own", None
            valid = ((pxb >= 0) & (pxb < tw) & (pyb >= 0) & (pyb < th))
            if mask is not None:
                valid = valid & np.broadcast_to(mask, (H, W))
            sel = np.flatnonzero(valid)
            return "scatter", (sel, pyb.reshape(-1)[sel],
                               pxb.reshape(-1)[sel])
        return self.ops.cache.memo("store_plan", plan, px, py, mask,
                                   th, tw, H, W)

    def _merge_store_list(self, stores, th, tw, base):
        """Merge recorded imageStores onto a (th, tw) target starting
        from `base` (list of 4 (th, tw) comps or None).  The common
        store-at-own-pixel case is a direct (masked) merge; other
        host-known patterns become index_put scatters.  Invocation grids
        are (self.H, self.W)-shaped and may differ from the target."""
        H, W = self.H, self.W
        ops = self.ops
        out = base
        for mask, px, py, val in stores:
            comps = [ops.dev(c).expand(H, W) if _is_traced(c) or
                     isinstance(c, np.ndarray) and c.ndim > 0
                     else ops.const(float(c), (H, W))
                     for c in val.comps]
            own_pixels = (th, tw) == (H, W) and self._store_plan(
                px, py, None, th, tw)[0] == "own"
            if own_pixels:
                if mask is None:
                    out = comps
                else:
                    prev = out or [ops.const(0.0, (H, W))] * 4
                    out = [self._amod(mask, c, p).where(mask, c, p)
                           for c, p in zip(comps, prev)]
                continue
            if mask is not None and _is_traced(mask):
                raise MpvHookError(
                    "conditional (data-dependent) imageStore at "
                    "non-invocation coordinates is not supported")
            _, (sel, rows, cols) = self._store_plan(px, py, mask, th, tw)
            prev = out or [ops.const(0.0, (th, tw))] * 4
            sel_t, rows_t, cols_t = (ops.index(a) for a in (sel, rows,
                                                              cols))
            merged = []
            for c, p in zip(comps, prev):
                vals = c.reshape(-1).index_select(0, sel_t)
                p = p.to(torch.promote_types(p.dtype, vals.dtype)).clone()
                p.index_put_((rows_t, cols_t), vals.to(p.dtype))
                merged.append(p)
            out = merged
        return out

    def _assemble_stores(self):
        """Merge out_image stores into the (4, out_h, out_w) pass
        output; pixels no store covers are 0 (undefined in GLSL).  In
        4-arg COMPUTE mode the invocation grid (H, W) is the thread
        grid, larger than the pixel block — stores scatter."""
        if not self._image_stores:
            raise MpvHookError(
                "compute hook() never called imageStore(out_image, ...)")
        return _Vec(self._merge_store_list(self._image_stores,
                                           self.out_h, self.out_w, None))

    def _collect_stex_writes(self):
        """Apply recorded STORAGE-texture stores read-modify-write on
        the current values (unstored texels keep their old content,
        like a real storage image)."""
        ops = self.ops
        for name, stores in self._stex_stores.items():
            cur = ops.dev(self.stex[name])              # (C, h, w)
            th, tw = cur.shape[-2], cur.shape[-1]
            base = [cur[c].to(torch.float32) if c < cur.shape[0] else
                    ops.const(1.0 if c == 3 else 0.0, (th, tw))
                    for c in range(4)]
            merged = self._merge_store_list(stores, th, tw, base)
            self.stex_writes[name] = torch.stack(
                [m.to(torch.float32) for m in merged[:cur.shape[0]]],
                dim=0)

    def _peek(self, k=0):
        return self.toks[self.pos + k] if self.pos + k < len(self.toks) \
            else None

    def _next(self):
        t = self._peek()
        self.pos += 1
        return t

    def _expect(self, t):
        got = self._next()
        if got != t:
            raise MpvHookError(f"expected {t!r}, got {got!r}")

    _TYPES = ("float", "int", "uint", "bool", "vec2", "vec3", "vec4",
              "ivec2", "ivec3", "ivec4", "uvec2", "uvec3", "uvec4")

    def _skip_block(self):
        """Advance past one statement or a balanced {...} block."""
        if self._peek() == "{":
            depth = 0
            while True:
                t = self._next()
                if t is None:
                    raise MpvHookError("unbalanced braces")
                if t == "{":
                    depth += 1
                elif t == "}":
                    depth -= 1
                    if depth == 0:
                        return
        else:
            while self._peek() not in (";", None):
                self._next()
            self._expect(";")

    def _run_block(self):
        """Execute one statement or a {...} block; returns the hook's
        return value if hit."""
        if self._peek() == "{":
            self._next()
            return self._run_statements(stop_at_brace=True)
        return self._run_one()

    def _for_stmt(self):
        """Constant-bound for loop, fully unrolled (community hooks loop
        over static tap offsets)."""
        self._expect("for")
        self._expect("(")
        if self._peek() in ("int", "uint", "float"):
            self._next()
        var = self._next()
        self._expect("=")
        init = self._expr()
        self._expect(";")
        if not init.scalar or hasattr(init.comps[0], "shape"):
            if self.compute is not None and self.shared and \
                    not _is_traced(init.comps[0]):
                # invocation-dependent start = the cooperative
                # shared-fill idiom; capture for replay instead
                return self._capture_shared_fill(var)
            raise MpvHookError("for-loop bounds must be static")
        cvar = self._next()
        if cvar != var:
            raise MpvHookError("for-loop condition must test the loop var")
        cmp_op = self._next()
        bound = self._expr()
        self._expect(";")
        if not bound.scalar or hasattr(bound.comps[0], "shape"):
            raise MpvHookError("for-loop bounds must be static")
        ivar = self._next()
        if ivar != var:
            raise MpvHookError("for-loop increment must update the "
                               "loop var")
        itok = self._next()
        if itok == "++":
            stepv = 1.0
        elif itok == "--":
            stepv = -1.0
        elif itok in ("+=", "-="):
            sv = self._expr()
            stepv = float(sv.comps[0]) * (1 if itok == "+=" else -1)
        else:
            raise MpvHookError(f"unsupported loop increment {itok!r}")
        self._expect(")")

        body_start = self.pos
        self._skip_block()
        body_end = self.pos

        tests = {"<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
                 ">": lambda a, b: a > b, ">=": lambda a, b: a >= b}
        if cmp_op not in tests:
            raise MpvHookError(f"unsupported loop comparison {cmp_op!r}")
        i = float(init.comps[0])
        b = float(bound.comps[0])
        iters = 0
        while tests[cmp_op](i, b):
            iters += 1
            if iters > 4096:
                raise MpvHookError("for loop exceeds 4096 iterations")
            self.vars[var] = _Vec([i], scalar=True)
            self.pos = body_start
            ret = self._run_block()
            if ret is not None:
                raise MpvHookError("return inside a loop is unsupported")
            i += stepv
        self.pos = body_end

    def _run_branch(self, mask):
        """Run one if-branch under a traced path condition.  Returns the
        branch's return value (or None); when it returns early, the
        remaining tokens of the branch are skipped so the caller lands
        at the branch end either way."""
        start = self.pos
        self._mask_stack.append(mask)
        try:
            ret = self._run_block()
        finally:
            self._mask_stack.pop()
        if ret is not None:
            self.pos = start
            self._skip_block()
        return ret

    def _register_return(self, cond, val):
        """Record an early return for lanes where `cond` AND every
        enclosing traced-branch condition holds."""
        if self.compute is not None and val is not _VOID_RETURN:
            # a conditional `return <value>;` in a compute shader would
            # otherwise be silently dropped (the compute path never
            # consults _pending_rets) — rejected like the top-level case
            raise MpvHookError("compute hook() must return void")
        mask = cond
        for m in self._mask_stack:
            mask = self._amod(mask, m).logical_and(mask, m)
        if val is _VOID_RETURN:
            # compute-mode `if (...) return;` — the usual OOB guard:
            # returned lanes simply stop storing
            self._dead = mask if self._dead is None else \
                self._amod(self._dead, mask).logical_or(self._dead, mask)
            return
        self._pending_rets.append((mask, val))

    def _if_stmt(self):
        """if/else: executed directly for static (host) conditions;
        per-pixel conditions run BOTH branches and merge every assigned
        variable with where (predication).  Early `return`s in traced
        branches become masked pending returns, merged first-return-wins
        at the end of the hook."""
        self._expect("if")
        self._expect("(")
        cond = self._expr()
        self._expect(")")
        c = cond.comps[0]
        if not hasattr(c, "shape"):
            if c:
                ret = self._run_block()
            else:
                self._skip_block()
                ret = None
            if self._peek() == "else":
                self._next()
                if not c:
                    return self._run_block()
                self._skip_block()
            return ret

        # traced condition: predicated execution of both branches.
        # Buffer members mutated through atomicAdd INSIDE a branch are
        # exempt from the where-merge below: the add already applies the
        # lane mask to its contribution, so branch effects compose
        # SEQUENTIALLY (then-branch adds feed the else branch), and they
        # survive the post-return state reset (lanes that add then
        # return did add).  PLAIN assignments to storage members keep the
        # normal merge: a uniform traced condition where-merges, a
        # per-pixel value errors in _collect_buf_writes.  "Added inside
        # this branch" is read from the append-only _atomic_log.
        snapshot = dict(self.vars)
        log_before = len(self._atomic_log)
        ret = self._run_branch(c)
        seq_then = {k for k in self._atomic_log[log_before:]
                    if k in self.vars}
        seq_names = set(seq_then)
        if ret is not None:
            self._register_return(c, ret)
            # returned lanes' variable state is unreachable; keep the
            # pre-if state for the merge below
            kept = {k: self.vars[k] for k in seq_names}
            self.vars = dict(snapshot)
            self.vars.update(kept)
        vars_then = self.vars
        self.vars = dict(snapshot)
        self.vars.update({k: vars_then[k] for k in seq_names})
        seq_else: set = set()
        if self._peek() == "else":
            self._next()
            not_c = self._amod(c).logical_not(c)
            log_before_else = len(self._atomic_log)
            ret = self._run_branch(not_c)
            seq_else = {k for k in self._atomic_log[log_before_else:]
                        if k in self.vars}
            seq_names |= seq_else
            if ret is not None:
                self._register_return(not_c, ret)
                kept = {k: self.vars[k] for k in seq_names}
                self.vars = dict(snapshot)
                self.vars.update(kept)
        vars_else = self.vars
        merged = dict(vars_else)
        for k, tv in vars_then.items():
            ev = vars_else.get(k)
            if ev is None:
                continue        # declared only inside the then-branch
            if tv is ev:
                merged[k] = tv  # untouched (incl. then-only adds the
                continue        # else branch inherited via the seeding)
            if k in seq_names:
                if k in seq_then and k in seq_else:
                    continue    # adds in BOTH branches: each is lane-
                                # masked, so they compose sequentially
                if k in seq_else and tv is snapshot.get(k):
                    continue    # else-only add, then untouched: the
                                # masked add stands on its own
                # mixed atomic/plain across the branches falls through
                # to the where-merge: exact for a uniform traced
                # condition (the losing branch's add is mask-zeroed),
                # and a per-pixel condition errors in _collect_buf_writes
            a, b2 = self._broadcast(tv, ev)
            merged[k] = _Vec([self._amod(c, x, y).where(c, x, y)
                              for x, y in zip(a.comps, b2.comps)],
                             scalar=a.scalar)
        self.vars = merged
        return None

    def _run_statements(self, stop_at_brace=False):
        while True:
            t = self._peek()
            if t is None:
                if stop_at_brace:
                    raise MpvHookError("unbalanced braces")
                return None
            if t == "}" and stop_at_brace:
                self._next()
                return None
            ret = self._run_one()
            if ret is not None:
                return ret

    def _run_one(self):
        """Execute exactly one statement; returns the hook return value
        when a `return` executes."""
        t = self._peek()
        if t == "return":
            self._next()
            if self._peek() == ";":
                # bare `return;` — only meaningful in a void hook()
                self._next()
                if self.compute is None:
                    raise MpvHookError("return without a value")
                return _VOID_RETURN
            v = self._expr()
            self._expect(";")
            return self._to_vec4(v)
        if t in ("barrier", "memoryBarrierShared", "groupMemoryBarrier",
                 "memoryBarrier") and self.compute is not None:
            # shared slots are pure functions of their index (replayed
            # on read), so publication is a no-op
            self._next()
            self._expect("(")
            self._expect(")")
            self._expect(";")
            return None
        if t == "imageStore":
            # out_image targets require compute mode (checked inside);
            # STORAGE-texture targets work from any pass kind
            self._next()
            self._image_store()
            self._expect(";")
            return None
        if t in self.shared and self._peek(1) == "[":
            return self._shared_write(t)
        if t == ";":
            self._next()
            return None
        if t == "for":
            self._for_stmt()
            return None
        if t == "if":
            return self._if_stmt()
        if t == "{":
            self._next()
            return self._run_statements(stop_at_brace=True)
        if t == "const":
            self._next()
            t = self._peek()
        if t in self._TYPES:
            self._next()
            name = self._next()
            if self._peek() == "[":
                # const array declaration with a type[](...) literal —
                # the ravu/adaptive-sharpen weight-table pattern; indices
                # must be static (unrolled loop vars are)
                self._next()
                if self._peek() != "]":
                    self._expr()                       # declared size
                self._expect("]")
                self._expect("=")
                lt = self._next()
                if lt not in self._TYPES:
                    raise MpvHookError(
                        f"array initializer must be a type[](...) "
                        f"literal, got {lt!r}")
                if self._peek() == "[":
                    self._next()
                    if self._peek() != "]":
                        self._expr()
                    self._expect("]")
                self._expect("(")
                elems = [self._expr()]
                while self._peek() == ",":
                    self._next()
                    elems.append(self._expr())
                self._expect(")")
                self._expect(";")
                self.arrays[name] = elems
                return None
            # one or more comma-separated declarators:
            #   float gx, gy;  /  float a = abd.x, b = abd.y;
            # integer declarations truncate (GLSL int semantics — makes
            # `int y = id / W;` integer division in compute fill math)
            int_decl = t in ("int", "uint") or \
                t.startswith(("ivec", "uvec"))
            while True:
                if self._peek() == "=":
                    self._next()
                    v = self._expr()
                    if int_decl:
                        v = self._materialize(v)
                        v = _Vec([self._trunc(c) for c in v.comps],
                                 scalar=v.scalar)
                    self.vars[name] = v
                else:
                    self.vars[name] = _Vec([0.0], scalar=True)
                if self._peek() != ",":
                    break
                self._next()
                name = self._next()
            self._expect(";")
            return None
        if t == "atomicAdd":
            # expression statement (the usual form: return value unused)
            self._next()
            self._atomic_add()
            self._expect(";")
            return None
        if t in self.arrays and self._peek(1) == "[":
            # array element assignment: NAME[static_idx] op= expr;
            if t in getattr(self, "_buf_names", ()) and \
                    t not in self.buf_writable:
                raise MpvHookError(
                    f"cannot assign to uniform buffer member {t!r}")
            self._next()
            self._next()
            idx = self._static_index(t)
            self._expect("]")
            op = self._next()
            val = self._expr()
            self._expect(";")
            cur = self.arrays[t][idx]
            if op == "=":
                self.arrays[t][idx] = val
            elif op in ("+=", "-=", "*=", "/="):
                self.arrays[t][idx] = self._binop(op[0], cur, val)
            else:
                raise MpvHookError(f"unsupported array assignment {op!r}")
            return None
        # assignment: name [.swz] (=|+=|-=|*=|/=|++|--) expr? ;
        name = self._next()
        if name not in self.vars:
            raise MpvHookError(f"unsupported statement at {name!r}")
        if name in getattr(self, "_buf_names", ()) and \
                name not in self.buf_writable:
            raise MpvHookError(
                f"cannot assign to uniform buffer member {name!r}")
        swz = None
        if self._peek() == ".":
            self._next()
            swz = self._next()
        op = self._next()
        if op in ("++", "--"):
            rhs = _Vec([1.0], scalar=True)
            op = "+=" if op == "++" else "-="
        elif op in ("=", "+=", "-=", "*=", "/="):
            rhs = self._expr()
        else:
            raise MpvHookError(f"unsupported assignment op {op!r}")
        self._expect(";")
        cur = self.vars[name]
        if swz is None:
            if op != "=":
                rhs = self._binop(op[0], cur, rhs)
            self.vars[name] = rhs
        else:
            idxs = [_SWIZ[c] for c in swz]
            comps = list(cur.comps)
            if op != "=":
                old = _Vec([comps[i] for i in idxs])
                rhs = self._binop(op[0], old, rhs)
            rhs_c = rhs.comps if len(rhs) == len(idxs) \
                else rhs.comps * len(idxs)
            for i, c in zip(idxs, rhs_c):
                comps[i] = c
            self.vars[name] = _Vec(comps)
        return None

    def _trunc(self, c):
        """GLSL integer conversion: truncation toward zero (+ 0.0 first:
        bools promote to float)."""
        if hasattr(c, "shape"):
            return self._amod(c).trunc(self.ops.arith("+", c, 0.0))
        return float(math.trunc(c))

    def _to_vec4(self, v) -> _Vec:
        if isinstance(v, _Pos):
            raise MpvHookError("hook() returned a position")
        comps = list(v.comps)
        while len(comps) < 4:
            comps.append(1.0 if len(comps) == 3 else 0.0)
        return _Vec(comps[:4])

    # -- expressions -----------------------------------------------------

    def _expr(self):
        return self._ternary()

    def _ternary(self):
        cond = self._or()
        if self._peek() == "?":
            self._next()
            a = self._ternary()
            self._expect(":")
            b = self._ternary()
            a = self._materialize(a)
            b = self._materialize(b)
            cond = self._materialize(cond)
            a, b = self._broadcast(a, b)
            c = cond.comps[0]
            if hasattr(c, "shape"):
                return _Vec([self._amod(c, x, y).where(c, x, y)
                             for x, y in zip(a.comps, b.comps)],
                            scalar=a.scalar)
            return a if c else b
        return cond

    def _binlevel(self, sub, ops):
        def parse():
            left = sub()
            while self._peek() in ops:
                op = self._next()
                right = sub()
                if isinstance(left, _Pos) or isinstance(right, _Pos):
                    left = self._pos_arith(op, left, right)
                else:
                    left = self._binop(op, left, right)
            return left
        return parse

    def _materialize(self, v):
        """Lower a symbolic _Pos to its per-pixel normalized coordinate
        value: a vec2 of host arrays ((1, W) u, (H, 1) v), made once per
        grid and transform, usable in arbitrary arithmetic and as static
        sampling coordinates (the ravu-zoom `fract(pos * size)`
        pattern)."""
        if not isinstance(v, _Pos):
            return v
        if _PROBE is not None:
            # position entered value arithmetic: the body is (possibly)
            # position-dependent, not shard-shift invariant
            _PROBE["pos_value"] = True

        def coords(W, H, scale, offset):
            u = ((np.arange(W, dtype=np.float64) + 0.5) / W
                 * scale[0] + offset[0]).astype(np.float32)[None, :]
            vv = ((np.arange(H, dtype=np.float64) + 0.5) / H
                  * scale[1] + offset[1]).astype(np.float32)[:, None]
            return [u, vv]
        return _Vec(self.ops.cache.memo("position", coords, self.W, self.H,
                                        tuple(v.scale), tuple(v.offset)))

    def _pos_arith(self, op, a, b):
        """Affine arithmetic on sampling positions stays symbolic
        (pos * scalar-const, pos +- vec2-const, pos / scalar-const);
        anything else materializes the position to host coordinate
        arrays and proceeds as ordinary value arithmetic."""
        pos, other = (a, b) if isinstance(a, _Pos) else (b, a)
        affine_ok = (not isinstance(other, _Pos) and
                     not any(hasattr(v, "shape") for v in other.comps))
        if affine_ok and op == "*":
            vals = other.comps
            sx = vals[0]
            sy = vals[1] if len(vals) > 1 else vals[0]
            return _Pos(pos.base, (pos.scale[0] * sx, pos.scale[1] * sy),
                        (pos.offset[0] * sx, pos.offset[1] * sy))
        if affine_ok and op == "/" and isinstance(a, _Pos):
            vals = other.comps
            sx = 1.0 / vals[0]
            sy = 1.0 / (vals[1] if len(vals) > 1 else vals[0])
            return _Pos(pos.base, (pos.scale[0] * sx, pos.scale[1] * sy),
                        (pos.offset[0] * sx, pos.offset[1] * sy))
        if affine_ok and op in ("+", "-") and isinstance(a, _Pos):
            vals = other.comps
            sgn = 1.0 if op == "+" else -1.0
            ox = vals[0]
            oy = vals[1] if len(vals) > 1 else vals[0]
            return _Pos(pos.base, pos.scale,
                        (pos.offset[0] + sgn * ox,
                         pos.offset[1] + sgn * oy))
        return self._binop(op, self._materialize(a), self._materialize(b))

    def _or(self):
        return self._binlevel(self._and, ("||",))()

    def _and(self):
        return self._binlevel(self._cmp, ("&&",))()

    def _cmp(self):
        return self._binlevel(
            self._add, ("<", ">", "<=", ">=", "==", "!="))()

    def _add(self):
        return self._binlevel(self._mul, ("+", "-"))()

    def _mul(self):
        return self._binlevel(self._unary, ("*", "/", "%"))()

    def _unary(self):
        t = self._peek()
        if t == "-":
            self._next()
            v = self._unary()
            return _Vec([self.ops.neg(c) for c in v.comps], scalar=v.scalar)
        if t == "!":
            self._next()
            v = self._unary()
            return _Vec([self.ops.invert(c) for c in v.comps],
                        scalar=v.scalar)
        if t == "+":
            self._next()
            return self._unary()
        return self._postfix()

    def _postfix(self):
        v = self._primary()
        while self._peek() in (".", "["):
            if self._next() == ".":
                swz = self._next()
                v = self._materialize(v)
                try:
                    idxs = [_SWIZ[c] for c in swz]
                except KeyError:
                    raise MpvHookError(f"bad swizzle {swz!r}")
                v = _Vec([v.comps[i] for i in idxs], scalar=len(idxs) == 1)
            else:
                # vector component indexing v[i]: static index selects
                # directly; per-pixel index selects through a where-chain
                # (the ravu-lite interleave pattern `res[idx]`)
                v = self._materialize(v)
                idx = self._expr()
                self._expect("]")
                if not idx.scalar and len(idx) != 1:
                    raise MpvHookError("vector index must be a scalar")
                i = idx.comps[0]
                if not hasattr(i, "shape"):
                    ii = int(i)
                    if not 0 <= ii < len(v):
                        raise MpvHookError(
                            f"vector index {ii} out of range")
                    v = _Vec([v.comps[ii]], scalar=True)
                else:
                    sel = v.comps[len(v) - 1]
                    for k in range(len(v) - 2, -1, -1):
                        sel = self._amod(i, v.comps[k], sel).where(
                            self.ops.arith("<", i, k + 0.5), v.comps[k],
                            sel)
                    v = _Vec([sel], scalar=True)
        return v

    _FUNCS1 = ("abs", "floor", "ceil", "fract", "sqrt", "inversesqrt",
               "exp", "exp2", "log", "log2", "sign", "sin", "cos", "tan",
               "asin", "acos", "round", "trunc",
               "normalize", "length", "saturate")

    def _primary(self):
        t = self._next()
        if t is None:
            raise MpvHookError("unexpected end of expression")
        if t == "(":
            v = self._expr()
            self._expect(")")
            return v
        if re.match(r"^(\d|\.\d)", t):
            return _Vec([float(t.rstrip("u"))], scalar=True)
        if t in ("vec2", "vec3", "vec4", "float", "int", "uint", "bool",
                 "ivec2", "ivec3", "ivec4", "uvec2", "uvec3", "uvec4"):
            nc = {"vec2": 2, "vec3": 3, "vec4": 4,
                  "ivec2": 2, "ivec3": 3, "ivec4": 4,
                  "uvec2": 2, "uvec3": 3, "uvec4": 4}.get(t, 1)
            self._expect("(")
            args = [self._materialize(self._expr())]
            while self._peek() == ",":
                self._next()
                args.append(self._materialize(self._expr()))
            self._expect(")")
            comps = []
            for a in args:
                comps.extend(a.comps)
            if len(comps) == 1 and nc > 1:
                comps = comps * nc
            if len(comps) < nc:
                raise MpvHookError(f"too few components for {t}")
            comps = comps[:nc]
            if t in ("int", "uint") or t.startswith(("ivec", "uvec")):
                comps = [self._trunc(c) for c in comps]
            elif t == "bool":
                comps = [self.ops.arith("!=", c, 0) if hasattr(c, "shape")
                         else bool(c) for c in comps]
            return _Vec(comps, scalar=nc == 1)
        if t in self._FUNCS1 or t in (
                "min", "max", "clamp", "mix", "pow", "mod", "step",
                "smoothstep", "dot", "distance", "atan"):
            return self._call(t)
        if t == "atomicAdd":
            return self._atomic_add()
        if t in ("texture", "textureLod", "texelFetch", "imageLoad"):
            # raw-GLSL sampling of a bound texture by name (the form
            # RAVU-generated shaders use; reference binds textures as
            # plain samplers, custom_mpv.c:305).  imageLoad reads a
            # STORAGE image at integer texel coords = texelFetch.
            return self._texture_call(
                "texelFetch" if t == "imageLoad" else t)
        # NAME_tex / NAME_texOff / NAME_pos / NAME_size / NAME_pt
        for suffix in ("_texOff", "_tex", "_pos", "_size", "_pt", "_off"):
            if t.endswith(suffix):
                base = t[:-len(suffix)]
                if base == "HOOKED":
                    base = self.hooked
                if base in self.tex:
                    return self._tex_access(base, suffix)
        if t in self.shared:
            self._expect("[")
            idxv = self._materialize(self._expr())
            self._expect("]")
            return self._shared_read(t, idxv)
        if t in self.arrays:
            self._expect("[")
            idx = self._static_index(t)
            self._expect("]")
            return self.arrays[t][idx]
        if t in self.vars:
            return self.vars[t]
        if t in self.params:
            return _Vec([float(self.params[t])], scalar=True)
        raise MpvHookError(f"unknown identifier {t!r}")

    def _atomic_add(self):
        """atomicAdd(member[, idx], value) on a STORAGE buffer member.
        hook() runs once per output pixel, so the reference's atomic
        accumulation over all invocations is a sum of the value
        expression over the output grid (a reduction instead of memory
        contention; its summation order differs from the JAX package's,
        so the totals agree to a relative tolerance).  Returns the value
        the member held before this pass's adds, like GLSL returns the
        pre-add value (deterministic here where GLSL's is
        scheduling-defined)."""
        self._expect("(")
        name = self._next()
        if name not in getattr(self, "_buf_names", ()):
            raise MpvHookError(
                f"atomicAdd target {name!r} is not a buffer member")
        if name not in self.buf_writable:
            raise MpvHookError(
                f"atomicAdd on read-only (uniform) buffer member {name!r}")
        idx = None
        if self._peek() == "[":
            self._next()
            idx = self._static_index(name)
            self._expect("]")
        self._expect(",")
        val = self._materialize(self._expr())
        self._expect(")")
        if not val.scalar and len(val) != 1:
            raise MpvHookError("atomicAdd value must be scalar")
        c = val.comps[0]
        # only ACTIVE lanes contribute: lanes killed by a compute-mode
        # early `return;` (_dead) or excluded by enclosing traced
        # if-branches (_mask_stack) never execute the add
        mask = self._dead if self._dead is None else self._amod(
            self._dead).logical_not(self._dead)
        for m in self._mask_stack:
            mask = m if mask is None else self._amod(mask, m).logical_and(
                mask, m)
        if mask is None:
            if hasattr(c, "shape"):
                # a device reduction even of a host value, as the JAX
                # package's jnp.sum is
                total = self.ops.plane(c, self.H, self.W).sum()
            else:
                total = float(c) * self.H * self.W
        else:
            am = self._amod(mask, c)
            contrib = am.broadcast_to(am.where(mask, c, 0.0),
                                      (self.H, self.W))
            total = am.sum(contrib)
            if am is self.ops.host:
                total = float(total)
        self._atomic_log.append(name)
        if idx is not None:
            old = self.arrays[name][idx]
            self.arrays[name][idx] = _Vec(
                [self.ops.arith("+", old.comps[0], total)], scalar=True)
        else:
            old = self.vars[name]
            self.vars[name] = _Vec(
                [self.ops.arith("+", old.comps[0], total)], scalar=True)
        return _Vec([old.comps[0]], scalar=True)

    def _static_index(self, name: str) -> int:
        """Parse an array index; must fold to a host constant (unrolled
        loop vars do)."""
        v = self._expr()
        if not v.scalar or hasattr(v.comps[0], "shape"):
            raise MpvHookError(
                f"array index into {name!r} must be static (per-pixel "
                "indices would be a gather)")
        idx = int(v.comps[0])
        if not 0 <= idx < len(self.arrays[name]):
            raise MpvHookError(f"array index {idx} out of range for "
                               f"{name!r}[{len(self.arrays[name])}]")
        return idx

    def _call(self, fname):
        self._expect("(")
        args = [self._expr()]
        while self._peek() == ",":
            self._next()
            args.append(self._expr())
        self._expect(")")
        # builtins operate on VALUES; positions materialize to their
        # per-pixel coordinate arrays (e.g. fract(HOOKED_pos * size))
        args = [self._materialize(a) for a in args]
        ops = self.ops
        ar = ops.arith

        def lift(f):
            a = args[0]
            return _Vec([f(c) for c in a.comps], scalar=a.scalar)

        def j(name, pyf):
            """Unary math: numpy for host arrays (keeps position-derived
            chains host-resolvable), torch for image data, Python for
            numbers."""
            def g(x):
                if hasattr(x, "shape"):
                    return getattr(self._amod(x), name)(x)
                return pyf(x)
            return g

        if fname in self._FUNCS1:
            table = {
                "abs": j("abs", abs), "floor": j("floor", math.floor),
                "ceil": j("ceil", math.ceil),
                "fract": lambda x: ar("-", x, (
                    self._amod(x).floor(x) if hasattr(x, "shape")
                    else math.floor(x))),
                "sqrt": j("sqrt", math.sqrt),
                "inversesqrt": lambda x: ar("/", 1, (
                    self._amod(x).sqrt(x) if hasattr(x, "shape")
                    else math.sqrt(x))),
                "exp": j("exp", math.exp),
                "exp2": j("exp2", lambda x: 2 ** x),
                "log": j("log", math.log),
                "log2": j("log2", math.log2),
                "sign": j("sign", lambda x: (x > 0) - (x < 0)),
                "sin": j("sin", math.sin), "cos": j("cos", math.cos),
                "tan": j("tan", math.tan),
                "asin": j("arcsin", math.asin),
                "acos": j("arccos", math.acos),
                "round": j("round", round),
                "trunc": j("trunc", math.trunc),
                "saturate": lambda x: (
                    self._amod(x).clip(x, 0, 1) if hasattr(x, "shape")
                    else min(max(x, 0.0), 1.0)),
            }
            if fname == "length":
                a = args[0]
                s = ops.total([ar("*", c, c) for c in a.comps])
                return _Vec([s ** 0.5 if not hasattr(s, "shape")
                             else self._amod(s).sqrt(s)], scalar=True)
            if fname == "normalize":
                a = args[0]
                s = ops.total([ar("*", c, c) for c in a.comps])
                inv = (1.0 / math.sqrt(s)) if not hasattr(s, "shape") \
                    else ar("/", 1.0, self._amod(s).sqrt(s))
                return _Vec([ar("*", c, inv) for c in a.comps])
            return lift(table[fname])

        if fname in ("min", "max"):
            return self._call_inline(fname, args[0], args[1])
        if fname == "clamp":
            x, lo, hi = args
            v = self._call_inline("max", x, lo)
            return self._call_inline("min", v, hi)
        if fname == "mix":
            a, b = self._broadcast(args[0], args[1])
            t = args[2]
            tt, _ = self._broadcast(t, a)
            return _Vec([ar("+", x, ar("*", ar("-", y, x), w))
                         for x, y, w in zip(a.comps, b.comps, tt.comps)],
                        scalar=a.scalar)
        if fname == "pow":
            a, b = self._broadcast(args[0], args[1])
            return _Vec([self._amod(x, y).power(x, y)
                         if hasattr(x, "shape") or hasattr(y, "shape")
                         else math.pow(x, y)
                         for x, y in zip(a.comps, b.comps)],
                        scalar=a.scalar)
        if fname == "mod":
            a, b = self._broadcast(args[0], args[1])
            return _Vec([self._amod(x, y).mod(x, y)
                         if hasattr(x, "shape") or hasattr(y, "shape")
                         else math.fmod(x, y)
                         for x, y in zip(a.comps, b.comps)],
                        scalar=a.scalar)
        if fname == "step":
            e, x = self._broadcast(args[0], args[1])
            return _Vec([self._amod(v, ee).where(ar("<", v, ee), 0.0, 1.0)
                         if hasattr(v, "shape") or hasattr(ee, "shape")
                         else (0.0 if v < ee else 1.0)
                         for ee, v in zip(e.comps, x.comps)],
                        scalar=x.scalar)
        if fname == "smoothstep":
            e0, e1, x = args
            e0, x = self._broadcast(e0, x)
            e1, x = self._broadcast(e1, x)
            out = []
            for a_, b_, v in zip(e0.comps, e1.comps, x.comps):
                t_ = ar("/", ar("-", v, a_), ar("-", b_, a_))
                t_ = self._amod(t_).clip(t_, 0.0, 1.0) \
                    if hasattr(t_, "shape") else min(max(t_, 0.0), 1.0)
                out.append(ar("*", ar("*", t_, t_),
                              ar("-", 3.0, ar("*", 2.0, t_))))
            return _Vec(out, scalar=x.scalar)
        if fname == "atan":
            if len(args) == 1:
                a = args[0]
                return _Vec([self._amod(c).arctan(c) if hasattr(c, "shape")
                             else math.atan(c) for c in a.comps],
                            scalar=a.scalar)
            y, x = self._broadcast(args[0], args[1])
            return _Vec([self._amod(a_, b_).arctan2(a_, b_)
                         if hasattr(a_, "shape") or hasattr(b_, "shape")
                         else math.atan2(a_, b_)
                         for a_, b_ in zip(y.comps, x.comps)],
                        scalar=y.scalar)
        if fname == "dot":
            a, b = self._broadcast(args[0], args[1])
            return _Vec([ops.total([ar("*", x, y)
                                    for x, y in zip(a.comps, b.comps)])],
                        scalar=True)
        if fname == "distance":
            a, b = self._broadcast(args[0], args[1])
            s = ops.total([ar("*", d, d) for d in
                           (ar("-", x, y) for x, y in zip(a.comps,
                                                          b.comps))])
            return _Vec([s ** 0.5 if not hasattr(s, "shape")
                         else self._amod(s).sqrt(s)], scalar=True)
        raise MpvHookError(f"unsupported function {fname!r}")

    def _call_inline(self, fname, *args):
        a, b = self._broadcast(args[0], args[1])
        nm = "minimum" if fname == "min" else "maximum"
        pf = min if fname == "min" else max
        return _Vec([getattr(self._amod(x, y), nm)(x, y)
                     if hasattr(x, "shape") or hasattr(y, "shape")
                     else pf(x, y) for x, y in zip(a.comps, b.comps)],
                    scalar=a.scalar)

    # -- texture access ----------------------------------------------------

    def _sample(self, base, pos):
        """Sample texture `base` at `pos`: a symbolic _Pos (separable
        static gather) or an explicit vec2 of normalized coordinates —
        host coords stay static gathers; data-dependent coords index
        bounded builtin //!TEXTUREs on the device."""
        tv = self.tex[base]
        if isinstance(pos, _Pos):
            return tv.sample(pos, (self.H, self.W))
        if len(pos) < 2:
            raise MpvHookError("texture coordinates must be a vec2")
        return tv.sample_coords(pos.comps[0], pos.comps[1],
                                (self.H, self.W))

    def _texture_call(self, fn):
        """texture(NAME, pos) / textureLod(NAME, pos, lod) /
        texelFetch(NAME, ivec2, lod)."""
        self._expect("(")
        name = self._next()
        if name == "HOOKED":
            name = self.hooked
        if name not in self.tex:
            raise MpvHookError(f"{fn} of unknown texture {name!r}")
        self._expect(",")
        pos = self._expr()
        if self._peek() == ",":
            self._next()
            self._expr()                     # lod — ignored (no mips)
        self._expect(")")
        tv = self.tex[name]
        if fn == "texelFetch":
            # integer texel coords -> normalized texel centers
            pos = self._materialize(pos)
            cx, cy = pos.comps[0], pos.comps[1]
            ar = self.ops.arith
            pos = _Vec([ar("/", ar("+", cx, 0.5), tv.w),
                        ar("/", ar("+", cy, 0.5), tv.h)])
        return self._sample(name, pos)

    def _tex_access(self, base, suffix):
        tv = self.tex[base]
        if suffix == "_pos":
            return _Pos(base)
        if suffix == "_size":
            return _Vec([float(tv.w), float(tv.h)])
        if suffix in ("_pt", "_off"):
            return _Vec([1.0 / tv.w, 1.0 / tv.h])
        if suffix == "_tex":
            self._expect("(")
            pos = self._expr()
            self._expect(")")
            return self._sample(base, pos)
        if suffix == "_texOff":
            self._expect("(")
            off = self._expr()
            self._expect(")")
            if isinstance(off, _Pos):
                raise MpvHookError("texOff takes an offset, not a "
                                   "position")
            vals = off.comps
            if any(hasattr(v, "shape") for v in vals):
                # per-pixel offsets: lower through explicit coordinates
                # (host ones stay static; data-dependent ones take the
                # bounded-LUT path in sample_coords)
                base_pos = self._materialize(_Pos(base))
                ox = vals[0]
                oy = vals[1] if len(vals) > 1 else ox
                ar = self.ops.arith
                return self._sample(base, _Vec(
                    [ar("+", base_pos.comps[0], ar("/", ox, tv.w)),
                     ar("+", base_pos.comps[1], ar("/", oy, tv.h))]))
            ox = float(vals[0])
            oy = float(vals[1]) if len(vals) > 1 else ox
            pos = _Pos(base, (1.0, 1.0), (ox / tv.w, oy / tv.h))
            return tv.sample(pos, (self.H, self.W))
        raise MpvHookError(suffix)


def _index_np(coord, size, border):
    """Border-aware integer index (host numpy)."""
    if border == "REPEAT":
        return np.mod(coord, size).astype(np.int64)
    if border == "MIRROR":
        period = 2 * size
        c = np.mod(coord, period)
        return np.where(c < size, c, period - 1 - c).astype(np.int64)
    return np.clip(coord, 0, size - 1).astype(np.int64)


def _sample_plan(H, W, scale, offset, w, h, nearest, border):
    """Host side of sampling a texture at an affine position: the
    separable row and column indices and the bilinear weights, made once
    per (grid, transform, texture size)."""
    xs = (np.arange(W, dtype=np.float64) + 0.5) / W
    ys = (np.arange(H, dtype=np.float64) + 0.5) / H
    px = (xs * scale[0] + offset[0]) * w - 0.5   # texel-space coordinates
    py = (ys * scale[1] + offset[1]) * h - 0.5
    # snap to texel centers: the normalized-coordinate roundtrip
    # ((i+0.5)/H +- k/H)*H leaves ~1e-14 residue for non-dyadic H,
    # which would otherwise push integral taps (texOff) onto the
    # bilinear path with fy ~ 1 — a 1-ulp wobble that varies with H
    px = np.where(np.abs(px - np.round(px)) < 1e-6, np.round(px), px)
    py = np.where(np.abs(py - np.round(py)) < 1e-6, np.round(py), py)
    if nearest:
        return ("nearest", _index_np(np.round(py), h, border),
                _index_np(np.round(px), w, border))
    x0 = np.floor(px)
    y0 = np.floor(py)
    fx = (px - x0).astype(np.float32)
    fy = (py - y0).astype(np.float32)
    iy0, ix0 = _index_np(y0, h, border), _index_np(x0, w, border)
    if np.all(fx < 1e-9) and np.all(fy < 1e-9):
        return ("texel", iy0, ix0)
    return ("bilinear", iy0, ix0, _index_np(y0 + 1, h, border),
            _index_np(x0 + 1, w, border), fx[None, :], fy[:, None])


def _coords_plan(u, v, w, h, linear, border):
    """Host side of sampling at explicit host coordinates: (iy, ix)
    pairs and, for LINEAR, the bilinear weights."""
    u = np.asarray(u, np.float64)
    v = np.asarray(v, np.float64)
    if linear:
        px = u * w - 0.5
        py = v * h - 0.5
        # snap to texel centers: coords computed by f32 GLSL arithmetic
        # (e.g. (vec2(p)+0.5)*HOOKED_pt) carry a ~px*2^-24 roundtrip
        # residue for non-dyadic sizes, which would put integral taps on
        # the bilinear path with ~1-ulp weights that vary with the image
        # height.  GL samplers quantize subtexel positions to 1/256
        # texels (GL_SUBPIXEL_BITS >= 8), so snapping within 1/1024 is
        # strictly more faithful than keeping the fp noise.
        px = np.where(np.abs(px - np.round(px)) < 2.0 ** -10,
                      np.round(px), px)
        py = np.where(np.abs(py - np.round(py)) < 2.0 ** -10,
                      np.round(py), py)
        x0 = np.floor(px)
        y0 = np.floor(py)
        fx = (px - x0).astype(np.float32)
        fy = (py - y0).astype(np.float32)
        iy0, iy1 = _index_np(y0, h, border), _index_np(y0 + 1, h, border)
        ix0, ix1 = _index_np(x0, w, border), _index_np(x0 + 1, w, border)
        return ((iy0, ix0), (iy0, ix1), (iy1, ix0), (iy1, ix1)), fx, fy
    return ((_index_np(np.floor(v * h), h, border),
             _index_np(np.floor(u * w), w, border)),), None, None


def _take_plan(iy, ix, H, W, w):
    """Host side of a static lookup into an image at integer texel coords
    of broadcastable shapes: ("sep", rows, cols) when the lookup is
    separable — ix constant down the columns and iy along the rows, as
    materialized positions always are; full (H, W) grids whose VALUES
    are separable (compute-hook workgroup arithmetic: (id % TW) is
    (H, W)-shaped but constant down the columns) collapse to 1-D — else
    ("flat", flat indices)."""
    if ix.ndim == 2 and ix.shape == (H, W) and \
            np.array_equal(ix, np.broadcast_to(ix[:1, :], ix.shape)):
        ix = ix[0]
    if iy.ndim == 2 and iy.shape == (H, W) and \
            np.array_equal(iy, np.broadcast_to(iy[:, :1], iy.shape)):
        iy = iy[:, :1]
    sep_x = ix.size == 1 or (ix.ndim >= 1 and ix.shape[-1] == ix.size)
    sep_y = iy.size == 1 or (iy.ndim == 2 and iy.shape[0] == iy.size)
    if sep_x and sep_y:
        yv = np.broadcast_to(iy.reshape(-1), (H,)) \
            if iy.size in (1, H) else iy.reshape(-1)
        xv = np.broadcast_to(ix.reshape(-1), (W,)) \
            if ix.size in (1, W) else ix.reshape(-1)
        return "sep", np.ascontiguousarray(yv), np.ascontiguousarray(xv)
    iyb = np.broadcast_to(iy, (H, W))
    ixb = np.broadcast_to(ix, (H, W))
    return "flat", np.ascontiguousarray(iyb * w + ixb), None


def _host_slices(table, coord, n, axis, out_dim, axis_name, linear,
                 border):
    """A host-resolvable axis of a data-dependent lookup: the table
    gathered along `axis` (K entries, K in {1, out_dim}); coord must be
    constant along the other output dimension (a number, or one value
    per output column / row)."""
    coord = np.asarray(coord, np.float64).reshape(-1)
    if coord.size not in (1, out_dim):
        raise MpvHookError(
            f"host {axis_name}-coordinate must be constant per "
            f"output {'column' if axis else 'row'} (got "
            f"{coord.size} values for {out_dim})")
    if linear:
        p = coord * n - 0.5
        lo = np.floor(p)
        f = (p - lo).astype(np.float32)
        t0 = np.take(table, _index_np(lo, n, border), axis=axis)
        t1 = np.take(table, _index_np(lo + 1, n, border), axis=axis)
        fb = f[:, None, None] if axis == 0 else f[None, :, None]
        return t0 + (t1 - t0) * fb
    idx = _index_np(np.floor(coord * n), n, border)
    return np.take(table, idx, axis=axis)


class _TexView:
    """A bindable texture: the hooked or a saved image ((C, H, W)
    tensor) or a builtin //!TEXTURE ((H, W, C) numpy array)."""

    # caps for data-dependent coordinates (the RAVU path), the JAX
    # package's: the lookup's table axis stays LUT-sized
    _DYN_AXIS_CAP = 8192     # one data-dependent axis (other one on host)
    _DYN_FLAT_CAP = 4096     # both axes data-dependent -> flattened table

    def __init__(self, name, data, filter="LINEAR", border="CLAMP",
                 is_builtin=False, ops: Optional[_Ops] = None):
        self.name = name
        self.data = data                 # (C, H, W) tensor or (H, W, C) np
        self.filter = filter
        self.border = border
        self.is_builtin = is_builtin
        self.ops = ops
        if is_builtin:
            self.h, self.w = data.shape[0], data.shape[1]
            self.comps = data.shape[2]
        else:
            self.h, self.w = data.shape[-2], data.shape[-1]
            self.comps = data.shape[-3]

    def _pad4(self, comps) -> _Vec:
        """Components past the texture's read (0, 0, 1)."""
        shape = comps[0].shape
        while len(comps) < 4:
            comps.append(self.ops.const(1.0 if len(comps) == 3 else 0.0,
                                        shape))
        return _Vec(comps)

    def _builtin_block(self, iy, ix, H, W, outer=False) -> torch.Tensor:
        """The builtin texture at host texel coords, (C, H, W) on the
        device (the JAX package's jnp.asarray of the gathered block):
        iy x ix broadcast, or their outer product (rows iy, cols ix)."""
        def make():
            if outer:
                block = self.data[np.ix_(iy, ix)]
            else:
                block = self.data[np.broadcast_to(iy, (H, W)),
                                  np.broadcast_to(ix, (H, W))]
            return torch.from_numpy(np.ascontiguousarray(
                np.moveaxis(block, -1, 0), np.float32)).to(self.ops.device)
        return self.ops.cache.upload(
            ("builtin", self.ops.device, id(self.data), id(iy), id(ix), H,
             W, outer), (self.data, iy, ix), make)

    def _blend(self, c00, c01, c10, c11, fx, fy) -> _Vec:
        ops = self.ops
        fx, fy = ops.dev(fx), ops.dev(fy)
        out = []
        for a, b, c, d in zip(c00.comps, c01.comps, c10.comps, c11.comps):
            top = a + (b - a) * fx
            bot = c + (d - c) * fx
            out.append(top + (bot - top) * fy)
        return _Vec(out)

    def sample(self, pos: _Pos, out_shape) -> _Vec:
        H, W = out_shape
        plan = self.ops.cache.memo(
            "sample", _sample_plan, H, W, tuple(pos.scale),
            tuple(pos.offset), self.w, self.h, self.filter == "NEAREST",
            self.border)
        if plan[0] in ("nearest", "texel"):
            return self._gather(plan[1], plan[2])
        _, iy0, ix0, iy1, ix1, fx, fy = plan
        return self._blend(self._gather(iy0, ix0), self._gather(iy0, ix1),
                           self._gather(iy1, ix0), self._gather(iy1, ix1),
                           fx, fy)

    def sample_coords(self, u, v, out_shape) -> _Vec:
        """Sample at explicit per-pixel normalized coordinates.

        * host coords (numbers, numpy): static lookups — the builtin
          table gathered on the host and uploaded once, images through
          index_select;
        * data-dependent coords into a builtin //!TEXTURE (the RAVU
          pattern — a small weight LUT indexed by a computed gradient
          feature): the table indexed on the device at the clamped
          texel indices, blended with the bilinear weights the JAX
          package puts in its one-/two-hot matrices (NEAREST: the one
          texel).  When one axis is host-resolvable, the table is
          gathered along it on the host first;
        * data-dependent coords into an image: rejected (a frame-sized
          per-pixel gather), as in the JAX package.
        """
        H, W = out_shape
        utr, vtr = _is_traced(u), _is_traced(v)
        linear = self.filter != "NEAREST"
        ops = self.ops

        if not utr and not vtr:
            taps, fx, fy = ops.cache.memo(
                "coords", _coords_plan, u, v, self.w, self.h, linear,
                self.border)
            looks = [self._take_hw(iy, ix, out_shape) for iy, ix in taps]
            if len(looks) == 1:
                return looks[0]
            return self._blend(*looks, fx, fy)

        if not self.is_builtin:
            raise MpvHookError(
                "data-dependent sampling coordinates are not supported "
                "for image-sized textures (requires per-pixel gather); "
                "only bounded //!TEXTURE LUTs may be indexed by computed "
                "values")

        table = self.data                                  # (h, w, C)
        C = self.comps

        def axis_taps(coord, n):
            """A data-dependent axis -> [(index, weight or None)]: two
            taps for LINEAR, one for NEAREST."""
            if n > self._DYN_AXIS_CAP:
                raise MpvHookError(
                    f"dynamic texture axis too large ({n} > "
                    f"{self._DYN_AXIS_CAP})")
            coord = ops.dev(coord)
            if linear:
                p = coord * n - 0.5
                lo = torch.floor(p)
                f = (p - lo).to(torch.float32)
                return [(self._index_t(lo, n), 1.0 - f),
                        (self._index_t(lo + 1.0, n), f)]
            return [(self._index_t(torch.floor(coord * n), n), None)]

        def device_table(t):
            """A host table (rows, C) as a (C, rows) device tensor, once
            per table."""
            return ops.cache.upload(
                ("table", ops.device, id(t)), t,
                lambda: torch.from_numpy(np.ascontiguousarray(
                    t.reshape(-1, C).T, np.float32)).to(ops.device))

        def lookup(flat_t, taps):
            """sum_k flat_t[:, index_k] * weight_k in tap order."""
            res = None
            for idx, wt in taps:
                g = flat_t[:, idx]
                if wt is not None:
                    g = g * wt
                res = g if res is None else res + g
            return res

        if utr and vtr:
            n = self.h * self.w
            if n > self._DYN_FLAT_CAP:
                raise MpvHookError(
                    f"dynamic 2D texture too large ({self.h}x{self.w} "
                    f"= {n} > {self._DYN_FLAT_CAP} texels)")
            flat_t = device_table(table)
            u, v = ops.dev(u), ops.dev(v)
            if linear:
                px = u * self.w - 0.5
                py = v * self.h - 0.5
                x0 = torch.floor(px)
                y0 = torch.floor(py)
                fx = (px - x0).to(torch.float32)
                fy = (py - y0).to(torch.float32)
                ix0 = self._index_t(x0, self.w)
                ix1 = self._index_t(x0 + 1.0, self.w)
                iy0 = self._index_t(y0, self.h)
                iy1 = self._index_t(y0 + 1.0, self.h)
                taps = [(iy0 * self.w + ix0, (1 - fx) * (1 - fy)),
                        (iy0 * self.w + ix1, fx * (1 - fy)),
                        (iy1 * self.w + ix0, (1 - fx) * fy),
                        (iy1 * self.w + ix1, fx * fy)]
            else:
                taps = [(self._index_t(torch.floor(v * self.h), self.h)
                         * self.w +
                         self._index_t(torch.floor(u * self.w), self.w),
                         None)]
        elif vtr:
            # y data-dependent, x on the host: the table's columns
            # gathered on the host -> (h, K, C)
            t = ops.cache.memo("slices", _host_slices, table, u, self.w, 1,
                               W, "x", linear, self.border)
            flat_t = device_table(t)
            taps = axis_taps(v, self.h)
            if t.shape[1] != 1:
                cols = ops.index(ops.cache.memo(
                    "columns", lambda W: np.arange(W)[None, :], W))
                taps = [(i * W + cols, wt) for i, wt in taps]
        else:
            # x data-dependent, y on the host: rows gathered -> (K, w, C)
            t = ops.cache.memo("slices", _host_slices, table, v, self.h, 0,
                               H, "y", linear, self.border)
            flat_t = device_table(t)
            taps = axis_taps(u, self.w)
            if t.shape[0] != 1:
                rows = ops.index(ops.cache.memo(
                    "rows", lambda H: np.arange(H)[:, None], H))
                taps = [(rows * self.w + i, wt) for i, wt in taps]
        if taps[0][0].dim() != 2:
            raise MpvHookError(
                "data-dependent texture coordinates must be per-pixel "
                f"(got shape {tuple(taps[0][0].shape)})")
        taps = [(i.expand(H, W), wt) for i, wt in taps]
        res = lookup(flat_t, taps)                         # (C, H, W)
        return self._pad4([res[c] for c in range(C)])

    def _index_t(self, coord, size):
        """Border-aware integer index (device).  The JAX package's
        one-hot compare selects nothing out of range, and XLA turns a NaN
        index into 0; torch would index out of bounds, so a NaN
        coordinate takes index 0 (its weight stays NaN, as the JAX
        package's does) and every index is clamped."""
        if self.border == "REPEAT":
            c = torch.remainder(coord, size)
        elif self.border == "MIRROR":
            period = 2 * size
            c = torch.remainder(coord, period)
            c = torch.where(c < size, c, period - 1 - c)
        else:
            c = torch.clamp(coord, 0, size - 1)
        return torch.nan_to_num(c, nan=0.0).clamp(0, size - 1).long()

    def _take_hw(self, iy, ix, out_shape) -> _Vec:
        """Static lookup at host integer texel coords of broadcastable
        shapes; separable where it can be (see _take_plan)."""
        H, W = out_shape
        iy = np.asarray(iy)
        ix = np.asarray(ix)
        if _PROBE is not None and not self.is_builtin:
            _PROBE["accesses"].append((_PROBE["passes"], iy, H))
        if self.is_builtin:
            block = self._builtin_block(iy, ix, H, W)
            return self._pad4([block[c] for c in range(self.comps)])
        plan = self.ops.cache.memo("take", _take_plan, iy, ix, H, W,
                                   self.w)
        if plan[0] == "sep":
            block = self._rows_cols(plan[1], plan[2])
        else:
            flat = self.ops.index(plan[1])
            block = self.data.reshape(self.data.shape[:-2] + (-1,))[
                ..., flat]
        return self._pad4([block[..., c, :, :] for c in range(self.comps)])

    def _rows_cols(self, yv, xv) -> torch.Tensor:
        """data[..., yv, :][..., xv]: two index_select gathers; a lookup
        of every texel in place is the image itself."""
        def is_identity(yv, xv, h, w):
            return yv.size == h and xv.size == w and \
                np.array_equal(yv, np.arange(h)) and \
                np.array_equal(xv, np.arange(w))
        if self.ops.cache.memo("identity", is_identity, yv, xv, self.h,
                               self.w):
            return self.data
        rows = self.data.index_select(-2, self.ops.index(yv))
        return rows.index_select(-1, self.ops.index(xv))

    def _gather(self, iy, ix) -> _Vec:
        """Gather rows iy (H,) x cols ix (W,) — separable static take."""
        if _PROBE is not None and not self.is_builtin:
            _PROBE["accesses"].append((_PROBE["passes"],
                                       np.asarray(iy), len(iy)))
        if self.is_builtin:
            block = self._builtin_block(iy, ix, len(iy), len(ix),
                                        outer=True)
            return self._pad4([block[c] for c in range(self.comps)])
        block = self._rows_cols(iy, ix)
        return self._pad4([block[..., c, :, :] for c in range(self.comps)])


# ---------------------------------------------------------------------------
# Hook assembly
# ---------------------------------------------------------------------------

def _init_carry(val) -> np.ndarray:
    """Canonical float32 carry array for a STORAGE buffer var's initial
    (parsed) value: (1,) scalars, (n,) vectors, (rows, rowlen) arrays/
    matrices — a STATIC shape, stable across frames."""
    a = np.asarray(val, np.float32)
    if a.ndim == 0:
        return a.reshape(1)
    if a.ndim > 2:
        return a.reshape(a.shape[0], -1)
    return a


def _carry_to_store(c) -> object:
    """Carried tensor -> the buffer-store value form the body runner
    consumes (_Vec / list of _Vec of 0-d tensors)."""
    if c.ndim == 2:
        return [_Vec([c[r, i] for i in range(c.shape[1])])
                for r in range(c.shape[0])]
    if c.shape[0] == 1:
        return _Vec([c[0]], scalar=True)
    return _Vec([c[i] for i in range(c.shape[0])])


def _store_to_carry(val, ops: _Ops) -> torch.Tensor:
    """Buffer-store value -> carried float32 tensor (inverse of
    _carry_to_store, also accepting the parsed host forms)."""
    def s(x):
        x = ops.dev(x)
        if isinstance(x, torch.Tensor):
            return x.to(torch.float32).reshape(())
        return torch.full((), float(x), dtype=torch.float32,
                          device=ops.device)
    if isinstance(val, list):
        return torch.stack([torch.stack([s(c) for c in v.comps])
                            for v in val])
    if isinstance(val, _Vec):
        return torch.stack([s(c) for c in val.comps])
    if isinstance(val, np.ndarray):
        a = ops.dev(np.asarray(val, np.float32)) if val.ndim else \
            s(val)
        return a.reshape(1) if a.ndim == 0 else a
    return s(val).reshape(1)


def _buffer_init(shader: UserShader) -> Dict[str, object]:
    """Every buffer member's parsed value in the store's form."""
    init: Dict[str, object] = {}
    for buf in shader.buffers.values():
        for bv in buf.vars:
            val = buf.values[bv.name]
            if isinstance(val, np.ndarray) and val.ndim >= 2:
                init[bv.name] = [_Vec(list(r)) for r in
                                 val.reshape(val.shape[0], -1)]
            else:
                init[bv.name] = val
    return init


def user_shader_hook(shader, parameters: Optional[Dict] = None) -> Hook:
    """Build a render.hooks.Hook executing this user shader's passes at
    their hooked stages (reference pl_mpv_user_shader_parse returning a
    pl_hook; execution engine renderer.c:1036).  The hook runs on the
    device of the image it is given; what it computes on the host is
    kept across frames (see the module docstring), in `hook.cache`."""
    if isinstance(shader, str):
        shader = parse_user_shader(shader)
    stages = HookStage(0)
    for p in shader.passes:
        for tname in p.hook_texs:
            st = _STAGE_MAP.get(tname)
            if st is not None:
                stages |= st

    # resolved parameter values
    par_vals: Dict[str, float] = {}
    enum_defs: Dict[str, str] = {}
    for name, par in shader.params.items():
        if par.type == "enum":
            # enum values become defines FOO=0 BAR=1...; default = first
            for idx, nm in enumerate(par.names):
                enum_defs[nm] = str(idx)
            par_vals[name] = float((parameters or {}).get(name, 0))
        else:
            v = float((parameters or {}).get(name, par.default))
            par_vals[name] = min(max(v, par.minimum), par.maximum)
    defines = dict(enum_defs)
    for name, par in shader.params.items():
        if par.mode == "define" and par.type != "enum":
            defines[name] = repr(par_vals[name]) if par.type == "float" \
                else str(int(par_vals[name]))
        elif par.type == "enum":
            defines[name] = str(int(par_vals[name]))

    # saved textures persist across the passes of one frame (= the
    # reference: hook_reset clears pass textures EVERY frame,
    # custom_mpv.c:941-944 via renderer.c:3371); cross-frame persistence
    # belongs to STORAGE textures and STORAGE buffers only
    store: Dict[str, object] = {}
    first_stage = last_stage = None
    for st in HookStage:
        if stages & st:
            if first_stage is None:
                first_stage = st
            last_stage = st

    # persistent state: STORAGE textures (PL_DESC_STORAGE_IMG) and
    # STORAGE buffer vars survive across frames on the hook object in
    # the reference; here the renderer carries them (Hook.state_spec)
    storage_texs = {n: t for n, t in shader.textures.items() if t.storage}
    storage_vars = [(buf, bv) for buf in shader.buffers.values()
                    if buf.storage for bv in buf.vars]
    state_spec: Dict[str, np.ndarray] = {}
    for n, t in storage_texs.items():
        state_spec["tex:" + n] = np.ascontiguousarray(
            np.moveaxis(t.data, -1, 0)).astype(np.float32)
    for buf, bv in storage_vars:
        state_spec["buf:" + bv.name] = _init_carry(buf.values[bv.name])

    cache = _Cache()
    ops_by_device: Dict[torch.device, _Ops] = {}

    def func(img, hp):
        nonlocal store
        ops = ops_by_device.get(img.device)
        if ops is None:
            ops = ops_by_device[img.device] = _Ops(img.device, cache)
        if hp.stage == first_stage:
            store = {}
            st_in = hp.state_in or {}
            if storage_texs:
                store["__stex__"] = {
                    n: (st_in["tex:" + n] if "tex:" + n in st_in
                        else ops.dev(state_spec["tex:" + n]))
                    for n in storage_texs}
            if shader.buffers:
                init = _buffer_init(shader)
                for buf, bv in storage_vars:
                    carried = st_in.get("buf:" + bv.name)
                    if carried is not None:
                        init[bv.name] = _carry_to_store(carried)
                store["__buffers__"] = init
        stage_name = _STAGE_NAME.get(hp.stage)
        cur = img
        # //!OFFSET rect updates apply transactionally: only after every
        # pass at this stage succeeded (a raising pass auto-disables the
        # whole hook and must leave the renderer's rect untouched)
        rect_updates: List[tuple] = []
        for p in shader.passes:
            applies = any(
                t == stage_name or
                (t in ("MAIN", "MAINPRESUB") and stage_name == "MAIN")
                for t in p.hook_texs)
            if not applies:
                continue
            cur = _run_pass(shader, p, cur, stage_name, store, par_vals,
                            defines, ops, hp, rect_updates)
        if hp.rect is not None:
            for upd in rect_updates:
                hp.rect.apply_pass(*upd)
        if hp.stage == last_stage and hp.state_out is not None:
            for n in storage_texs:
                hp.state_out["tex:" + n] = store["__stex__"][n]
            for buf, bv in storage_vars:
                hp.state_out["buf:" + bv.name] = _store_to_carry(
                    store["__buffers__"][bv.name], ops)
        return cur

    h = Hook(stages=stages, func=func, name=shader.name,
             parameters=dict(par_vals))
    h.user_shader = shader
    h.cache = cache
    if state_spec:
        h.state_spec = state_spec
    return h


def _run_pass(shader: UserShader, p: ShaderPass, img, stage_name,
              store, par_vals, defines, ops: _Ops, hp=None,
              rect_updates=None):
    H, W = img.shape[-2], img.shape[-1]

    # texture views available to this pass
    views: Dict[str, _TexView] = {stage_name: _TexView(stage_name, img,
                                                       ops=ops)}
    if stage_name == "MAIN":
        views["MAINPRESUB"] = views["MAIN"]
    stex = store.get("__stex__") or {}
    for tname, tex in shader.textures.items():
        if tex.storage:
            # persistent STORAGE image: bind its CURRENT (possibly
            # carried / previously-written) value
            views[tname] = _TexView(tname, stex[tname], tex.filter,
                                    tex.border, ops=ops)
        else:
            views[tname] = _TexView(tname, tex.data, tex.filter,
                                    tex.border, is_builtin=True, ops=ops)
    for tname, arr in store.items():
        if not tname.startswith("__"):      # "__buffers__" is not a tex
            views[tname] = _TexView(tname, arr, ops=ops)

    sizes = {name: (tv.h, tv.w) for name, tv in views.items()}
    sizes["HOOKED"] = (H, W)
    # the render target's size, for the canonical upscaling-hook gate
    # "WHEN OUTPUT.w HOOKED.w / <ratio> >" (reference: the OUTPUT tex in
    # the shexpr namespace, custom_mpv.c WHEN handling)
    if hp is not None and hp.dst_w and hp.dst_h:
        sizes.setdefault("OUTPUT", (hp.dst_h, hp.dst_w))
        sizes.setdefault("NATIVE", (hp.src_h, hp.src_w))
    if hp is not None and getattr(hp, "size_override", None):
        # a hook run on part of a frame: local sizes, global WHEN gating
        sizes.update(hp.size_override)
    # WHEN gating (reference custom_mpv.c WHEN + shexp eval)
    if p.cond is not None:
        if not _eval_shexpr(p.cond, sizes, par_vals):
            return img
    # output size
    out_h, out_w = H, W
    if p.width is not None:
        out_w = int(round(_eval_shexpr(p.width, sizes, par_vals)))
    if p.height is not None:
        out_h = int(round(_eval_shexpr(p.height, sizes, par_vals)))
    if out_h <= 0 or out_w <= 0:
        raise MpvHookError("non-positive hook output size")

    # resolve binds (HOOKED alias + availability check)
    hooked = stage_name
    bind_views = {}
    for b in p.bind_texs:
        name = hooked if b == "HOOKED" else (
            "MAINPRESUB" if b == "MAIN" and "MAINPRESUB" in views else b)
        if name not in views:
            raise MpvHookError(f"pass binds unknown texture {b!r}")
        bind_views[name] = views[name]
    if not bind_views:
        bind_views = {hooked: views[hooked]}
    bind_views.setdefault(hooked, views[hooked])

    # //!BUFFER members: current values live in the per-frame store
    # (initialized from the parsed payload the first time a pass of
    # this shader runs each frame); STORAGE writes flow to later passes
    buf_vals = None
    buf_writable = None
    if shader.buffers:
        if "__buffers__" not in store:
            store["__buffers__"] = _buffer_init(shader)
        buf_vals = store["__buffers__"]
        buf_writable = {bv.name for buf in shader.buffers.values()
                        if buf.storage for bv in buf.vars}

    compute = block = None
    if p.is_compute:
        compute = (p.threads_w, p.threads_h)
        block = (p.block_w, p.block_h)
    runner = _BodyRunner(bind_views, hooked, par_vals, defines,
                         (out_h, out_w), ops, buf_vals=buf_vals,
                         buf_writable=buf_writable, compute=compute,
                         block=block,
                         stex={k: v for k, v in stex.items()
                               if k in bind_views})
    result = runner.run(p.body)
    if shader.buffers:
        store["__buffers__"].update(runner.buf_writes)
    if runner.stex_writes:
        store["__stex__"].update(runner.stex_writes)

    # //!OFFSET / ALIGN: declared rect shifts feed the renderer's
    # sampling-rect accumulator so downstream scaling compensates
    # (reference custom_mpv.c:1533-1551)
    writes_hooked = p.save_tex in (None, "HOOKED")
    declares_off = p.offset != (0.0, 0.0) or p.offset_align
    if declares_off and not writes_hooked:
        raise MpvHookError(
            "//!OFFSET on a pass that SAVEs to a named texture is not "
            "supported (only the HOOKED rect is tracked)")
    if writes_hooked:
        if declares_off and (hp is None or
                             getattr(hp, "rect", None) is None):
            raise MpvHookError(
                f"//!OFFSET declared at stage {stage_name}, where the "
                "renderer cannot compensate the sampling rect "
                "(supported at the per-plane input stages and "
                "NATIVE/MAIN/LINEAR/SIGMOID/PREKERNEL)")
        if rect_updates is not None and hp is not None and \
                getattr(hp, "rect", None) is not None:
            # a resizing pass also SCALES any previously-accumulated
            # offset (rect_n = s * rect_{n-1} + o) — recorded even with
            # no declared offset
            rect_updates.append((out_w / W, out_h / H, p.offset,
                                 p.offset_align))

    comps = p.components or img.shape[-3]
    out = torch.stack([ops.plane(c, out_h, out_w)
                       for c in result.comps[:comps]], dim=-3)

    if p.save_tex and p.save_tex != "HOOKED":
        store[p.save_tex] = out
        return img
    return out

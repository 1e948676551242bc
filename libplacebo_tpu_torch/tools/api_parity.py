#!/usr/bin/env python3
"""Check the committed API parity map against the port.

docs/API_PARITY.md maps every public reference symbol (PL_API functions
of the reference's headers) to the JAX package's analog.  This check
reads that committed document (it does not regenerate it and reads no
reference header) and resolves each "yes" row's backticked analog under
`libplacebo_tpu_torch`, through an explicit rename map (the port's
names for the same objects):

    TpuContext -> GpuContext, TpuLimits -> GpuLimits,
    ops.pallas.* -> ops.cuda.*

A dotted analog resolves when its longest importable module prefix has
the rest as attributes; a bare name when a module of the package, or a
class defined in one, has it.  `DOCUMENT_ONLY` lists the backticked
words of the document that name no object of the JAX package either
(prose fragments and stale names); they are not checked.  Prints what
does not resolve and exits 1 if anything does.

Usage: python3 -m libplacebo_tpu_torch.tools.api_parity
"""
import importlib
import inspect
import os
import pkgutil
import re
import sys
from typing import Dict, List

PACKAGE = "libplacebo_tpu_torch"
DOC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "docs", "API_PARITY.md")

RENAMES = {"TpuContext": "GpuContext", "TpuLimits": "GpuLimits",
           "pallas": "cuda"}

# backticked words of the committed document that the JAX package does
# not resolve either: the `_ex` of "the `_ex` callback form", a JAX
# call, and names the document gives its queue class and distortion op
# (render.queue.FrameQueue, ops.distort's functions)
DOCUMENT_ONLY = frozenset({
    "_ex", "jax.device_put", "ops.distort.distort",
    "render.queue.Queue.estimate_fps", "render.queue.Queue.estimate_vps",
    "render.queue.Queue.num_frames", "render.queue.Queue.peek",
    "render.queue.Queue.pts_offset", "render.queue.Queue.push",
    "render.queue.Queue.push_block", "render.queue.Queue.reset",
    "render.queue.Queue.update"})


def yes_targets(doc: str = DOC) -> Dict[str, List[str]]:
    """{backticked analog: [reference symbols]} of the "yes" rows."""
    out: Dict[str, List[str]] = {}
    with open(doc) as f:
        for line in f:
            m = re.match(r"\| `(pl_\w+)` \| yes \| (.*) \|$", line.rstrip())
            if not m:
                continue
            for t in re.findall(r"`([A-Za-z_][A-Za-z_0-9.]*)`", m.group(2)):
                out.setdefault(t, []).append(m.group(1))
    return out


def _renamed(target: str, renames) -> List[str]:
    return [renames.get(p, p) for p in target.split(".")]


def _bare_names(package: str) -> set:
    """Every attribute of every Python module of `package` and of every
    class defined in one (built extension libraries are not modules)."""
    pkg = importlib.import_module(package)
    names = set(dir(pkg))
    for info in pkgutil.walk_packages(pkg.__path__, package + "."):
        try:
            mod = importlib.import_module(info.name)
        except ImportError:
            continue
        names.update(dir(mod))
        for _, cls in inspect.getmembers(mod, inspect.isclass):
            if cls.__module__ == mod.__name__:
                names.update(dir(cls))
    return names


def resolves(target: str, package: str, renames, bare: set) -> bool:
    """Whether `target` names an object of `package` (`bare`: its
    `_bare_names`)."""
    parts = _renamed(target, renames)
    if len(parts) == 1:
        return parts[0] in bare
    for i in range(len(parts), -1, -1):
        try:
            obj = importlib.import_module(".".join([package] + parts[:i]))
        except ImportError:
            continue
        for p in parts[i:]:
            if not hasattr(obj, p):
                return False
            obj = getattr(obj, p)
        return True
    return False


def unresolved(package: str = PACKAGE, renames=RENAMES, doc: str = DOC,
               skip=DOCUMENT_ONLY) -> Dict[str, List[str]]:
    """{analog: [reference symbols]} that do not resolve in `package`."""
    bare = _bare_names(package)
    return {t: syms for t, syms in yes_targets(doc).items()
            if t not in skip and not resolves(t, package, renames, bare)}


def main(argv=None) -> int:
    targets = yes_targets()
    bad = unresolved()
    print(f"{len(targets)} analogs of the \"yes\" rows, "
          f"{len(targets) - len(DOCUMENT_ONLY & set(targets))} checked "
          f"under {PACKAGE} (renames {RENAMES}): {len(bad)} do not resolve")
    for t, syms in sorted(bad.items()):
        print(f"  {t}  ({', '.join(syms)})")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

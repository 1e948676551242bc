"""Build native sources at first use into the ignored `build/` directory
beside the package, and load them with ctypes.

Two toolchains: g++ for host code (the blue-noise generator, the film
grain tables) and nvcc for the hand-written Hopper kernels (`csrc/*.cu`,
sm_90a, a plain C interface — no PyTorch headers, so a build takes
seconds).  A build that fails raises: there is no fallback
implementation to drop back to.

A library is named by its spec, (name, sources, compiler, flags).
`build_all` starts one compiler process for every spec at once, so a
fresh checkout builds in the time of its slowest library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["BUILD_DIR", "build_all", "build_log", "build_shared",
           "generated_include", "load_shared", "nvcc_path"]

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build",
                         "libplacebo_tpu_torch")

_lock = threading.Lock()
_loaded: dict = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or install the CUDA "
                       "toolkit under /usr/local/cuda)")


def generated_include(filename: str, text: str) -> str:
    """Write `text`, a source made at build time, as
    BUILD_DIR/gen-<hash>/<filename> and return that directory for `-I`.
    Its name follows the text, so the flags, and with them the hash of
    every library built against it, change when the text does."""
    digest = hashlib.sha256(f"{filename}\n{text}".encode()).hexdigest()
    inc = os.path.join(BUILD_DIR, f"gen-{digest[:16]}")
    path = os.path.join(inc, filename)
    if not os.path.exists(path):
        os.makedirs(inc, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    return inc


def _digest(paths, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _start(name: str, sources, compiler: str, flags):
    """(output path, compiler process or None when already built).  The
    library is written under a temporary name and renamed by `_finish`,
    so concurrent builders (test workers) never load a half-written
    file."""
    sources = [os.path.join(_PKG, s) for s in sources]
    out = os.path.join(BUILD_DIR, f"{name}-{_digest(sources, flags)}.so")
    if os.path.exists(out):
        return out, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [compiler] + list(flags) + ["-shared", "-o", tmp] + sources
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, (name, cmd, tmp, proc)


def _finish(out: str, job) -> str:
    """Wait for a build from `_start`; keep what the compiler printed
    beside the library as <name>-<hash>.so.log."""
    if job is None:
        return out
    name, cmd, tmp, proc = job
    try:
        log, _ = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise RuntimeError(f"build of {name} failed ({' '.join(cmd)}):\n"
                           f"{log}")
    with open(f"{tmp}.log", "w") as f:
        f.write(log)
    os.replace(f"{tmp}.log", f"{out}.log")
    os.replace(tmp, out)
    return out


def build_shared(name: str, sources, compiler: str, flags) -> str:
    """Compile `sources` into BUILD_DIR/<name>-<hash>.so (content-hashed,
    so an edited source rebuilds) and return its path."""
    return _finish(*_start(name, sources, compiler, flags))


def build_all(specs) -> list:
    """build_shared for every (name, sources, compiler, flags) spec, all
    compiler processes started together; returns the paths."""
    jobs = [_start(*spec) for spec in specs]
    try:
        return [_finish(out, job) for out, job in jobs]
    finally:
        for _, job in jobs:
            if job is not None and job[3].poll() is None:
                job[3].kill()
                job[3].wait()


def build_log(lib: ctypes.CDLL) -> str:
    """What the compiler printed while building `lib` (with nvcc's
    `-Xptxas -v`: each kernel's registers, stack frame and spills)."""
    with open(f"{lib._name}.log") as f:
        return f.read()


def load_shared(name: str, sources, compiler: str, flags) -> ctypes.CDLL:
    """build_shared + ctypes load, once per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_shared(name, sources, compiler, flags))
            _loaded[name] = lib
        return lib

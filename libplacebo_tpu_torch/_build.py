"""Build native sources at first use into the ignored `build/` directory
beside the package, and load them with ctypes.

Two toolchains: g++ for host code (the blue-noise generator, the film
grain tables) and nvcc for the hand-written Hopper kernels (`csrc/*.cu`,
sm_90a, a plain C interface — no PyTorch headers, so a build takes
seconds).  A build that fails raises: there is no fallback
implementation to drop back to.

A library is named by its spec, (name, sources, compiler, flags).
`build_all` starts one compiler process for every spec at once (up to
two a CPU core), so a fresh checkout builds in the time of its slowest
library.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

__all__ = ["BUILD_DIR", "KernelError", "is_kernel_failure", "kernel_work",
           "build_all", "build_log", "build_shared", "generated_include",
           "include_digest", "load_shared", "nvcc_path", "set_build_dir"]

_PKG = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build",
                         "libplacebo_tpu_torch")

_lock = threading.Lock()
_loaded: dict = {}


def set_build_dir(path: str) -> str:
    """Build into `path` from now on (runtime.GpuContext.set_disk_cache).
    Libraries this process has already loaded stay loaded; the setting
    applies to builds it has not made yet.  Libraries are named by the
    hash of their sources and flags, so the directory can be shared
    between processes and machines with the same toolchain."""
    global BUILD_DIR
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    with _lock:
        BUILD_DIR = path
    return path


class KernelError(RuntimeError):
    """A hand-written kernel failed to build, load or launch."""


# the exception type PyTorch raises for an error the CUDA runtime
# reports (older versions raise a RuntimeError starting "CUDA error")
_ACCELERATOR_ERROR = getattr(torch, "AcceleratorError", None)


def is_kernel_failure(exc: BaseException) -> bool:
    """Whether `exc` is a kernel's failure or a CUDA error: after one
    the context may be unusable, and a re-render would only hide the
    cause."""
    if isinstance(exc, KernelError):
        return True
    if _ACCELERATOR_ERROR is not None and isinstance(exc, _ACCELERATOR_ERROR):
        return True
    return isinstance(exc, RuntimeError) and str(exc).startswith("CUDA error")


@contextlib.contextmanager
def kernel_work(name: str):
    """Raise whatever fails inside the block as a KernelError: the block
    is a kernel's own work on the card (its outputs' allocation, its
    library, its launch), and no caller may take such a failure, an
    out-of-memory error included, for a plain stage's."""
    try:
        yield
    except KernelError:
        raise
    except Exception as e:
        raise KernelError(f"{name} failed: {type(e).__name__}: {e}") from e


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found (set NVCC or install the CUDA "
                       "toolkit under /usr/local/cuda)")


def include_digest(filename: str, text: str) -> str:
    """The hash that names a generated source's directory."""
    return hashlib.sha256(f"{filename}\n{text}".encode()).hexdigest()[:16]


def generated_include(filename: str, text: str) -> str:
    """Write `text`, a source made at build time, as
    BUILD_DIR/gen-<hash>/<filename> and return that directory for `-I`.
    Its name follows the text, so the flags, and with them the hash of
    every library built against it, change when the text does."""
    inc = os.path.join(BUILD_DIR, f"gen-{include_digest(filename, text)}")
    path = os.path.join(inc, filename)
    if not os.path.exists(path):
        os.makedirs(inc, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    return inc


def _digest(paths, flags) -> str:
    """The hash of the flags, the sources and the CUDA headers beside
    them (`*.cuh`, which a kernel source may include)."""
    h = hashlib.sha256(" ".join(flags).encode())
    dirs = sorted({os.path.dirname(p) for p in paths if p.endswith(".cu")})
    headers = [os.path.join(d, n) for d in dirs
               for n in sorted(os.listdir(d)) if n.endswith(".cuh")]
    for p in list(paths) + headers:
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
    except subprocess.TimeoutExpired as e:
        proc.kill()
        proc.communicate()
        raise KernelError(f"build of {name} timed out") from e
    if proc.returncode != 0:
        raise KernelError(f"build of {name} failed ({' '.join(cmd)}):\n"
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
    """build_shared for every (name, sources, compiler, flags) spec, the
    compiler processes started together (at most two a CPU core at a
    time, in order); returns the paths."""
    specs = list(specs)
    limit = 2 * (os.cpu_count() or 4)
    jobs: list = []
    try:
        paths = []
        for i in range(len(specs)):
            while len(jobs) < min(len(specs), i + limit):
                jobs.append(_start(*specs[len(jobs)]))
            paths.append(_finish(*jobs[i]))
        return paths
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
            path = build_shared(name, sources, compiler, flags)
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise KernelError(f"loading {path} failed: {e}") from e
            _loaded[name] = lib
        return lib

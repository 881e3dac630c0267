"""Build and load the hand-written CUDA kernels under ``kernels/csrc/``.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with :mod:`ctypes`. Nothing
is built when the package is imported: the first kernel launch calls
:func:`library`, which builds on first use and then keeps the loaded library
for the life of the process.

- Each source compiles to its own object, all ``nvcc`` processes started
  together, and the objects link into ``build/repro_torch/kernels-<hash>.so``
  at the repository root. The hash covers every source and the flags, so a
  changed source builds a new library; an unchanged tree reuses the one on
  disk. Files are written under a temporary name and renamed into place, so
  two processes building at once never load a half-written library.
- ``nvcc`` comes from ``PATH`` or ``/usr/local/cuda/bin``. When there is
  none, :func:`library` raises: a CUDA tensor never silently runs the plain
  version instead of its kernel.
- A source may add flags of its own (:data:`SOURCE_FLAGS`), and each
  object's hash covers the flags it was compiled with. A source compiled
  with ``-rdc=true`` (relocatable device code: its kernels launch kernels
  from the device) goes through one device-link step against ``cudadevrt``
  (``nvcc -dlink``), whose object joins the shared link.
- Each C entry point takes ``c_void_p`` device pointers and the CUDA stream
  and returns ``cudaGetLastError()`` after its launch; :func:`check` turns a
  nonzero status into an exception naming the kernel.
- Each wrapper counts its launches with :func:`count`, under one lock, so
  the threaded serving client's lanes lose no count.
- The library carries its own CUDA runtime. On a host thread that has not
  yet touched the device (a serving client's lane thread), that runtime
  finds no current context and refuses a launch that sets a kernel
  attribute first ("invalid argument"); :func:`function` therefore makes
  torch's current device current on each new thread before handing out an
  entry point.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

__all__ = ["BuildError", "library", "function", "check", "count", "build_info", "SOURCES_DIR"]

SOURCES_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH,
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    # Per-kernel registers, shared memory and spills land in the build log.
    "-Xptxas", "-v",
)
# Flags of one source on top of NVCC_FLAGS. mandelbrot.cu launches child
# grids from the device (Dynamic Parallelism), which needs relocatable
# device code and a device link against the device runtime.
RDC = "-rdc=true"
SOURCE_FLAGS = {"mandelbrot.cu": (RDC,)}
DEVICE_RUNTIME = "-lcudadevrt"


class BuildError(RuntimeError):
    """The kernels could not be built or loaded (no nvcc, a compile error)."""


class _Loaded:
    """The process's loaded library plus what its build took."""

    def __init__(self, lib: ctypes.CDLL, info: dict) -> None:
        self.lib = lib
        self.info = info
        self.functions: dict[str, ctypes._CFuncPtr] = {}


_LOADED: _Loaded | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.access(default, os.X_OK):
        return default
    raise BuildError(
        "nvcc not found on PATH or in /usr/local/cuda/bin; the CUDA kernels "
        "cannot be built, so CUDA tensors cannot be served"
    )


def _digest(*parts: bytes) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(len(p).to_bytes(8, "little"))
        h.update(p)
    return h.hexdigest()[:16]


def _run(cmd: list[str]) -> subprocess.Popen:
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )


def _build() -> tuple[Path, dict]:
    sources = sorted(SOURCES_DIR.glob("*.cu"))
    if not sources:
        raise BuildError(f"no CUDA sources under {SOURCES_DIR}")
    headers = b"".join(p.read_bytes() for p in sorted(SOURCES_DIR.glob("*.cuh")))
    flags = {src: (*NVCC_FLAGS, *SOURCE_FLAGS.get(src.name, ())) for src in sources}
    objects = {
        src: BUILD_DIR / (
            f"{src.stem}-{_digest(' '.join(flags[src]).encode(), headers, src.read_bytes())}.o")
        for src in sources
    }
    relocatable = [objects[src] for src in sources if RDC in flags[src]]
    lib_path = BUILD_DIR / (
        "kernels-" + _digest(*(o.name.encode() for o in objects.values())) + ".so"
    )
    info = {"path": str(lib_path), "cached": lib_path.exists(), "seconds": 0.0,
            "log": ""}
    if lib_path.exists():
        return lib_path, info
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    logs = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src, obj in objects.items():
            if obj.exists():
                continue
            tmp_obj = Path(tmp) / obj.name
            cmd = [nvcc, *flags[src], "-c", str(src), "-o", str(tmp_obj)]
            jobs.append((src, obj, tmp_obj, _run(cmd)))
        for src, obj, tmp_obj, proc in jobs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                raise BuildError(f"nvcc failed on {src.name}:\n{out}")
            os.replace(tmp_obj, obj)
        linked = [str(o) for o in objects.values()]
        if relocatable:
            dlink = Path(tmp) / "device-link.o"
            cmd = [nvcc, *ARCH, "-Xcompiler", "-fPIC", "-dlink", *map(str, relocatable),
                   "-o", str(dlink), DEVICE_RUNTIME]
            proc = _run(cmd)
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise BuildError(f"device link of {[o.name for o in relocatable]} failed:\n{out}")
            linked += [str(dlink), DEVICE_RUNTIME]
        tmp_lib = Path(tmp) / lib_path.name
        link = [nvcc, "-shared", "-o", str(tmp_lib), *linked]
        proc = _run(link)
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise BuildError(f"linking {lib_path.name} failed:\n{out}")
        os.replace(tmp_lib, lib_path)
    info["seconds"] = time.perf_counter() - t0
    info["log"] = "".join(logs)
    return lib_path, info


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LOADED
    if _LOADED is None:
        path, info = _build()
        _LOADED = _Loaded(ctypes.CDLL(str(path)), info)
        err = _LOADED.lib.repro_cuda_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return _LOADED.lib


def build_info() -> dict:
    """Path, build seconds, whether it was reused from disk, and nvcc's log
    (with ptxas' per-kernel resource lines) of the loaded library."""
    library()
    assert _LOADED is not None
    return dict(_LOADED.info)


_THREAD = threading.local()


def _bind_thread() -> None:
    """Make torch's current CUDA device (and its context) current on this
    host thread, once a thread."""
    if not getattr(_THREAD, "bound", False):
        import torch

        if torch.cuda.is_available():
            torch.cuda.set_device(torch.cuda.current_device())
        _THREAD.bound = True


def function(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry point ``name`` with its argument types declared once,
    the calling thread bound to the device first."""
    _bind_thread()
    lib = library()
    assert _LOADED is not None
    fn = _LOADED.functions.get(name)
    if fn is None:
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _LOADED.functions[name] = fn
    return fn


def check(status: int, name: str) -> None:
    """Raise when a C entry point reported a CUDA error for its launch."""
    if status != 0:
        text = library().repro_cuda_error_string(status).decode()
        raise RuntimeError(f"kernel {name} failed to launch: {text} ({status})")


_COUNT_LOCK = threading.Lock()


def count(counter: dict, name: str, n: int = 1) -> None:
    """``counter[name] += n`` under one lock: a launch counter read exactly
    stays exact when several threads launch."""
    with _COUNT_LOCK:
        counter[name] += n

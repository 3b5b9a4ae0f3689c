"""Build the CUDA sources in ``csrc/`` (and the port's host C++ sources)
at first use and load them; check the tensors a kernel wrapper hands to
them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
its own by ``nvcc`` for Hopper (``sm_90a``) into a shared library, then
loaded with ``ctypes``. No PyTorch header is included, so a build takes
seconds. A host source (``native/mel.cpp``) is compiled by ``g++`` with
the JAX package's flags (flowtron_tpu/native/build.sh) through
``load_host_library``. Libraries go to the build directory,
``build/torch_kernels/`` at the root of the checkout unless
``set_build_dir`` (the server's ``--compile-cache``) names another, named
by a hash of the source, the shared headers (``csrc/*.cuh``, CUDA only)
and the flags, so an edit rebuilds and an unchanged source is reused, by
this process or by a later one pointed at the same directory. A host
library's hash also takes the CPU model, since ``-march=native`` builds
for the CPU it runs on.

Nothing here runs at import time: the CPU tests import every module on
machines with no ``nvcc``. Each library loads under its own lock (the
server's dispatcher and stream threads launch kernels side by side, and
``chip_smoke.py`` builds the sources in parallel).
"""

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
# the build directory (``set_build_dir`` moves it)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"   # where nvcc is not on PATH
GXX_FLAGS = ["-O3", "-march=native", "-ffast-math", "-shared", "-fPIC",
             "-std=c++17"]
GXX_LIBS = ["-lpthread"]

_loaded = {}
_locks = {}                       # name -> the lock of its build and load
_locks_lock = threading.Lock()
# name -> compiler seconds of this process's build (0.0 when a library was
# reused)
build_seconds = {}


def set_build_dir(path):
    """Build into and load from ``path`` from now on. Raises, naming both
    directories, once a library has been loaded from another one: a
    process keeps one build directory."""
    global BUILD_DIR
    path = Path(path).resolve()
    with _locks_lock:
        if path != BUILD_DIR and _loaded:
            raise RuntimeError(
                f"cannot move the kernel build directory to {path}: "
                f"{sorted(_loaded)} already loaded from {BUILD_DIR}")
        BUILD_DIR = path


def _nvcc():
    path = shutil.which("nvcc") or NVCC_DEFAULT
    if not os.path.exists(path):
        raise RuntimeError(
            f"nvcc not found (looked on PATH and at {NVCC_DEFAULT}); the "
            "CUDA kernels are built with: nvcc " + " ".join(NVCC_FLAGS)
            + " -o <lib>.so <src>.cu")
    return path


def _gxx():
    path = shutil.which("g++")
    if path is None:
        raise RuntimeError("g++ not found on PATH; the host libraries are "
                           "built with: g++ " + " ".join(GXX_FLAGS)
                           + " -o <lib>.so <src>.cpp " + " ".join(GXX_LIBS))
    return path


def _cpu_model():
    """The CPU's model name, else its vendor, family and model numbers
    (/proc/cpuinfo), else the machine type."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                if not key.strip():
                    break                      # the first CPU's block only
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    if fields.get("model name"):
        return fields["model name"]
    ids = [fields[k] for k in ("vendor_id", "cpu family", "model")
           if fields.get(k)]
    return " ".join(ids) if ids else platform.machine()


def load_library(name):
    """Build (if needed) and load ``csrc/<name>.cu``; returns the CDLL."""
    return _load(name, CSRC / f"{name}.cu", host=False)


def load_host_library(src):
    """Build (if needed) with ``g++`` and load the host C++ source ``src``;
    returns the CDLL."""
    src = Path(src)
    return _load(src.stem, src, host=True)


def host_library_path(src):
    """Where ``load_host_library(src)`` builds its library in the current
    build directory (it exists once built)."""
    return _lib_path(Path(src), host=True)


def _load(name, src, host):
    if name in _loaded:
        return _loaded[name]
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name not in _loaded:
            _loaded[name] = _build_and_load(name, src, host)
    return _loaded[name]


def _lib_path(src, host):
    if host:
        extra = (" ".join(GXX_FLAGS + GXX_LIBS) + _cpu_model()).encode()
    else:
        # the shared headers too, so an edit of one rebuilds its includers
        extra = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh"))) \
            + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(src.read_bytes() + extra).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def _build_and_load(name, src, host):
    lib_path = _lib_path(src, host)
    if lib_path.exists():
        build_seconds[name] = 0.0
    else:
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp.so")
        if host:
            cmd = [_gxx()] + GXX_FLAGS + ["-o", str(tmp), str(src)] \
                + GXX_LIBS
        else:
            cmd = [_nvcc()] + NVCC_FLAGS + ["-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {src.name} failed (exit {proc.returncode}): "
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
        build_seconds[name] = time.perf_counter() - t0
    return ctypes.CDLL(str(lib_path))


def check_tensor(name, t, shape, device, contiguous=True,
                 dtype=torch.float32, align=16):
    """Raise unless ``t`` is a ``dtype`` tensor of ``shape`` on ``device``,
    ``align``-byte aligned and (unless ``contiguous=False``) contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}; expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if (contiguous and not t.is_contiguous()) or t.data_ptr() % align:
        raise ValueError(f"{name} must be contiguous and {align}-byte "
                         "aligned")


def check_barriers(n_barriers, grid):
    """Raise unless a launch of ``grid`` blocks may pass ``n_barriers``
    grid barriers on one 32-bit counter (csrc/grid_sync.cuh: each barrier
    adds ``grid`` to the counter, which is never reset during a launch)."""
    if n_barriers * grid >= 2 ** 32:
        raise ValueError(f"{n_barriers} grid barriers of {grid} blocks "
                         "overflow the barrier's 32-bit counter")

"""Build the CUDA sources in ``csrc/`` at first use and load them; check
the tensors a kernel wrapper hands to them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
its own by ``nvcc`` for Hopper (``sm_90a``) into a shared library, then
loaded with ``ctypes``. No PyTorch header is included, so a build takes
seconds. Libraries go to ``build/torch_kernels/`` at the root of the
checkout, named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edit rebuilds and an unchanged
source is reused.

Nothing here runs at import time: the CPU tests import every module on
machines with no ``nvcc``. Each library loads under its own lock (the
server's dispatcher and stream threads launch kernels side by side, and
``chip_smoke.py`` builds the sources in parallel).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"   # where nvcc is not on PATH

_loaded = {}
_locks = {}                       # name -> the lock of its build and load
_locks_lock = threading.Lock()
# name -> nvcc seconds of this process's build (0.0 when a library was reused)
build_seconds = {}


def _nvcc():
    path = shutil.which("nvcc") or NVCC_DEFAULT
    if not os.path.exists(path):
        raise RuntimeError(
            f"nvcc not found (looked on PATH and at {NVCC_DEFAULT}); the "
            "CUDA kernels are built with: nvcc " + " ".join(NVCC_FLAGS)
            + " -o <lib>.so <src>.cu")
    return path


def load_library(name):
    """Build (if needed) and load ``csrc/<name>.cu``; returns the CDLL."""
    if name in _loaded:
        return _loaded[name]
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name not in _loaded:
            _loaded[name] = _build_and_load(name)
    return _loaded[name]


def _build_and_load(name):
    src = CSRC / f"{name}.cu"
    # the shared headers too, so an edit of one rebuilds its includers
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"{name}-{digest}.so"
    if lib_path.exists():
        build_seconds[name] = 0.0
    else:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp.so")
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

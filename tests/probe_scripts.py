"""Helpers of tests/test_torch_port_probes_*.py: import a TPU probe script
of ``scripts/`` unchanged and capture what its Pallas bodies and XLA
baselines compute.

The scripts parse ``sys.argv`` and set JAX's compilation cache directory
at import, and exp_fused_cost.py runs its three variants at import (on
the CPU each fails at once with "Only interpret mode is supported").
``load_script`` imports a fresh copy with ``sys.argv`` of one element and
restores both afterwards. Bodies nested in the scripts' functions are
reached through the module's globals: ``JitRecorder`` stands in for the
module's ``jax`` and keeps the result of every jitted call.
"""

import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def load_script(name):
    """A fresh module object of ``scripts/<name>.py``."""
    argv, cache = sys.argv, jax.config.jax_compilation_cache_dir
    sys.argv = [name]
    try:
        spec = importlib.util.spec_from_file_location(
            f"probe_script_{name}", ROOT / "scripts" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.argv = argv
        jax.config.update("jax_compilation_cache_dir", cache)
    return mod


class JitRecorder:
    """``jax`` for a script's globals: ``jit`` returns a function that runs
    the real jitted function once per argument tuple, keeps its result in
    ``outputs`` and returns it again for the script's timing repeats;
    every other attribute is the real ``jax``'s."""

    def __init__(self):
        self.outputs = []

    def __getattr__(self, name):
        return getattr(jax, name)

    def jit(self, fn, **kwargs):
        f = jax.jit(fn, **kwargs)
        cache = {}

        def run(*args):
            key = tuple(id(a) for a in args)
            if key not in cache:
                cache[key] = f(*args)
                self.outputs.append(cache[key])
            return cache[key]
        return run


def f32(a):
    """A JAX or numpy array as a float32 numpy array."""
    return np.asarray(jax.numpy.asarray(a).astype(jax.numpy.float32))


def assert_within_bf16_ulp(out, ref):
    """Every element of ``out`` within one bf16 step of ``ref`` (the step
    at the larger magnitude of the two): the bar for a bf16 result whose
    fp32 sum was taken in another order."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    mag = np.maximum(np.maximum(np.abs(out), np.abs(ref)), 2.0 ** -126)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    bad = np.abs(out - ref) > ulp
    assert not bad.any(), (
        f"{int(bad.sum())} of {bad.size} elements more than one bf16 step "
        f"apart; max abs diff {float(np.abs(out - ref).max())}")

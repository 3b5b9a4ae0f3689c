"""ctypes bindings for the native (C++) data-pipeline library (port of
flowtron_tpu/native/__init__.py, over the port's own copy of its source,
``native/mel.cpp``).

``NativeMel`` gives ``MelSpectrogram.mel_numpy``'s log-mel (same window
and mel basis arrays, same framing) within 1e-5; ``decode_wav`` parses
PCM16 WAVs without scipy. The library is built at first use by
``ops/_build.py:load_host_library`` (``g++``, the JAX package's flags)
into the build directory, never into the package. ``available()`` is
True once it is built there; ``build()`` builds it.
"""

import ctypes
import os
from pathlib import Path

import numpy as np

from flowtron_tpu_torch.ops import _build

SOURCE = Path(__file__).resolve().parent / "mel.cpp"


def _load():
    lib = _build.load_host_library(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.mel_create.restype = ctypes.c_void_p
        lib.mel_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_float, f32p, f32p]
        lib.mel_destroy.restype = None
        lib.mel_destroy.argtypes = [ctypes.c_void_p]
        lib.mel_compute.restype = ctypes.c_int
        lib.mel_compute.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int64,
                                    f32p, ctypes.c_int]
        lib.wav_decode_pcm16.restype = ctypes.c_int64
        lib.wav_decode_pcm16.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, f32p,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int)]
        lib._argtypes_set = True
    return lib


def build():
    """Build the library with ``g++`` (if it is not built yet) and load it;
    True on success, raises with the compiler's output otherwise."""
    return _load() is not None


def available():
    """Whether the library is built in the build directory (or loaded)."""
    return SOURCE.stem in _build._loaded \
        or _build.host_library_path(SOURCE).exists()


def _f32ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeMel:
    """waveform (float32, [-1, 1]) -> (n_mels, n_frames) log-mel, in C++."""

    def __init__(self, window, mel_basis, filter_length=1024,
                 hop_length=256, clip_val=1e-5, n_threads=0):
        self._lib = _load()
        self.filter_length = filter_length
        self.hop_length = hop_length
        window = np.ascontiguousarray(window, np.float32)
        mel_basis = np.ascontiguousarray(mel_basis, np.float32)
        self.n_mels = mel_basis.shape[0]
        self.n_threads = n_threads or (os.cpu_count() or 1)
        self._handle = self._lib.mel_create(
            filter_length, hop_length, self.n_mels, ctypes.c_float(clip_val),
            _f32ptr(window), _f32ptr(mel_basis))

    def __call__(self, audio):
        audio = np.ascontiguousarray(audio, np.float32)
        n_frames = len(audio) // self.hop_length + 1
        out = np.empty((self.n_mels, n_frames), np.float32)
        got = self._lib.mel_compute(self._handle, _f32ptr(audio), len(audio),
                                    _f32ptr(out), self.n_threads)
        if got != n_frames:
            raise RuntimeError(f"native mel gave {got} frames, expected "
                               f"{n_frames} ({len(audio)} samples)")
        return out

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.mel_destroy(self._handle)
            self._handle = None


def decode_wav(path):
    """PCM16 WAV -> (float32 samples in integer scale, sampling_rate)."""
    lib = _load()
    raw = np.fromfile(path, np.uint8)
    max_samples = len(raw) // 2
    out = np.empty(max_samples, np.float32)
    sr = ctypes.c_int(0)
    n = lib.wav_decode_pcm16(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(raw),
        _f32ptr(out), max_samples, ctypes.byref(sr))
    if n < 0:
        raise ValueError(f"unsupported wav format: {path}")
    return out[:n].copy(), sr.value

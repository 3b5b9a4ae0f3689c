"""Inverse STFT and Griffin-Lim phase recovery (port of
flowtron_tpu/audio/griffin_lim.py; reference:audio_processing.py:59-75,
237-265): irfft, window, overlap-add, window-sumsquare normalisation.

``InverseSTFT`` and ``griffin_lim`` run on tensors of any device (the
denoiser runs ``InverseSTFT`` on the card); ``istft_numpy`` and
``griffin_lim_numpy`` are the host path of the vocoder-less CLI and
server, in numpy as in the JAX package.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from flowtron_tpu_torch.audio.stft import hann_window, on_device, pad_center


def window_sumsquare(win_length, filter_length, hop_length, n_frames):
    """Sum-square envelope of the analysis window (numpy, host-side)."""
    n = filter_length + hop_length * (n_frames - 1)
    x = np.zeros(n, dtype=np.float64)
    win_sq = pad_center(hann_window(win_length).astype(np.float64) ** 2,
                        filter_length)
    for i in range(n_frames):
        s = i * hop_length
        x[s:min(n, s + filter_length)] += \
            win_sq[:max(0, min(filter_length, n - s))]
    return x


def _overlap_add(frames, filter_length, hop_length):
    """(B, n_frames, filter_length) -> (B, filter_length + hop * (n_frames
    - 1)) overlap-add, as one ``fold``."""
    b, n_frames, _ = frames.shape
    n = filter_length + hop_length * (n_frames - 1)
    out = F.fold(frames.transpose(1, 2), output_size=(1, n),
                 kernel_size=(1, filter_length), stride=(1, hop_length))
    return out.reshape(b, n)


class InverseSTFT:
    def __init__(self, filter_length=1024, hop_length=256, win_length=1024):
        self.filter_length = filter_length
        self.hop_length = hop_length
        self.win_length = win_length
        self.window = pad_center(hann_window(win_length), filter_length)
        # the window a device, the normalisation a (n_frames, dtype,
        # device): a caller's n_frames takes few values (the engine's is
        # fixed, Griffin-Lim's the same every iteration)
        self._on_device = {}

    def _norm(self, n_frames, dtype, device):
        wss = window_sumsquare(self.win_length, self.filter_length,
                               self.hop_length, n_frames)
        norm = np.where(wss > np.finfo(np.float32).tiny, wss, 1.0)
        return torch.as_tensor(norm, dtype=dtype, device=device)

    def __call__(self, magnitude, phase):
        """(B, n_bins, n_frames) magnitude and phase tensors -> (B, hop *
        (n_frames - 1)) waveform."""
        n_frames, dev = magnitude.shape[-1], magnitude.device
        spec = torch.polar(magnitude, phase)
        window = on_device(self._on_device, ("window", dev),
                           lambda: torch.as_tensor(self.window, device=dev))
        frames = torch.fft.irfft(spec.transpose(1, 2), n=self.filter_length,
                                 dim=-1) * window
        signal = _overlap_add(frames, self.filter_length, self.hop_length)
        signal = signal / on_device(
            self._on_device, ("norm", n_frames, signal.dtype, dev),
            lambda: self._norm(n_frames, signal.dtype, dev))
        # irfft carries the 1/filter_length factor: no hop-ratio rescale
        pad = self.filter_length // 2
        return signal[:, pad:-pad]


def griffin_lim(magnitudes, stft_forward, stft_inverse, n_iters=30,
                angles=None, generator=None):
    """Recover a waveform from (B, n_bins, n_frames) magnitudes by
    iterative phase estimation. ``stft_forward(signal)`` gives the complex
    spectrum, ``stft_inverse(magnitude, phase)`` the signal. The initial
    phases are ``angles`` when given, else uniform in [-pi, pi) drawn on
    the CPU from ``generator`` (default: seeded 0), so a seed gives the
    same phases on every device."""
    if angles is None:
        g = generator or torch.Generator().manual_seed(0)
        angles = (torch.rand(magnitudes.shape, generator=g) * 2 - 1) * math.pi
    angles = angles.to(magnitudes.device, magnitudes.dtype)
    signal = stft_inverse(magnitudes, angles)
    for _ in range(n_iters):
        signal = stft_inverse(magnitudes, stft_forward(signal).angle())
    return signal


def istft_numpy(magnitude, phase, filter_length=1024, hop_length=256,
                win_length=1024):
    """(n_bins, n_frames) mag/phase -> (T,) waveform, numpy end to end."""
    window = pad_center(hann_window(win_length).astype(np.float64),
                        filter_length)
    spec = magnitude.astype(np.float64) * np.exp(1j * phase.astype(np.float64))
    frames = np.fft.irfft(spec.T, n=filter_length, axis=-1) * window[None, :]

    n_frames = frames.shape[0]
    n = filter_length + hop_length * (n_frames - 1)
    out = np.zeros(n)
    for i in range(n_frames):
        out[i * hop_length:i * hop_length + filter_length] += frames[i]

    wss = window_sumsquare(win_length, filter_length, hop_length, n_frames)
    tiny = np.finfo(np.float32).tiny
    out = out / np.where(wss > tiny, wss, 1.0)
    pad = filter_length // 2
    return out[pad:-pad].astype(np.float32)


def griffin_lim_numpy(magnitudes, filter_length=1024, hop_length=256,
                      win_length=1024, n_iters=30, seed=0):
    """(n_bins, n_frames) magnitudes -> (T,) waveform, numpy end to end."""
    window = pad_center(hann_window(win_length).astype(np.float64),
                        filter_length)
    rng = np.random.default_rng(seed)
    angles = rng.uniform(-np.pi, np.pi, magnitudes.shape)

    def forward(signal):
        pad = filter_length // 2
        # reflect needs pad < len(signal); ultra-short synthesis (a gate
        # that fires within the first frames) falls back to zero padding
        mode = "reflect" if signal.size > pad else "constant"
        x = np.pad(signal.astype(np.float64), pad, mode=mode)
        n_frames = magnitudes.shape[1]
        frames = np.stack([
            x[i * hop_length:i * hop_length + filter_length]
            for i in range(n_frames)
        ])
        return np.fft.rfft(frames * window[None, :], axis=-1).T

    signal = istft_numpy(magnitudes, angles, filter_length, hop_length,
                         win_length)
    for _ in range(n_iters):
        spec = forward(signal)
        angles = np.angle(spec)
        signal = istft_numpy(magnitudes, angles, filter_length, hop_length,
                             win_length)
    return signal

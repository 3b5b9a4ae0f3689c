"""STFT and log-mel spectrogram (port of flowtron_tpu/audio/stft.py): the
host numpy path of the data pipeline (``MelSpectrogram.mel_numpy``) and
the tensor path on any device (``_frame_signal``, ``magnitude``,
``__call__``, ``mel_from_magnitude``, with ``torch.fft.rfft``), which the
denoiser and Griffin-Lim use.

TacotronSTFT semantics (reference:audio_processing.py:96-134): reflect
padding of ``filter_length // 2`` on each side, periodic Hann window
(zero-center-padded to ``filter_length``), hop stride, ``n_frames =
T // hop + 1``, Slaney mel filterbank, log of the magnitude mel clipped at
``clip_val``.
"""

from functools import lru_cache

import numpy as np
import torch

from flowtron_tpu_torch.audio.mel import mel_filterbank


def hann_window(win_length, dtype=np.float32):
    """Periodic (fftbins=True) Hann window, as scipy.signal.get_window."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(dtype)


def pad_center(window, size):
    """Zero-pad a window symmetrically to ``size`` samples."""
    n = len(window)
    lpad = (size - n) // 2
    return np.pad(window, (lpad, size - n - lpad))


def _reflect_index(T, pad):
    """Indices of ``numpy.pad(x, pad, mode="reflect")`` into x (T,), any
    pad width (reflection repeats with period 2 (T - 1))."""
    i = np.arange(-pad, T + pad)
    if T == 1:
        return np.zeros_like(i)
    period = 2 * (T - 1)
    m = np.mod(i, period)
    return np.where(m < T, m, period - m)


@lru_cache(maxsize=64)
def _reflect_index_on(T, pad, device):
    """``_reflect_index`` as a tensor on ``device``, built once a length."""
    return torch.as_tensor(_reflect_index(T, pad), device=device)


def on_device(cache, key, make):
    """``cache[key]``, made by ``make()`` on first use: the host constants
    (windows, bases, normalisations) copied once a device, not a call."""
    t = cache.get(key)
    if t is None:
        t = cache[key] = make()
    return t


def _frame_signal(audio, filter_length, hop_length):
    """(B, T) -> (B, n_frames, filter_length) frames of the reflect-padded
    signal (zero-padded at the end where the last frame needs it),
    ``n_frames = T // hop + 1``."""
    T = audio.shape[1]
    n_frames = T // hop_length + 1
    idx = _reflect_index_on(T, filter_length // 2, audio.device)
    x = audio.index_select(1, idx)
    need = (n_frames - 1) * hop_length + filter_length
    if x.shape[1] < need:
        x = torch.nn.functional.pad(x, (0, need - x.shape[1]))
    return x.unfold(1, filter_length, hop_length)[:, :n_frames]


class MelSpectrogram:
    """waveform -> log-mel: ``mel_numpy`` on the host in numpy, the rest
    on tensors of any device."""

    def __init__(self, filter_length=1024, hop_length=256, win_length=1024,
                 n_mel_channels=80, sampling_rate=22050, mel_fmin=0.0,
                 mel_fmax=8000.0, clip_val=1e-5):
        if filter_length < win_length:
            raise ValueError(f"filter_length {filter_length} < win_length "
                             f"{win_length}")
        self.filter_length = filter_length
        self.hop_length = hop_length
        self.n_mel_channels = n_mel_channels
        self.clip_val = clip_val
        self.window = pad_center(hann_window(win_length), filter_length)
        self.mel_basis = mel_filterbank(sampling_rate, filter_length,
                                        n_mel_channels, mel_fmin, mel_fmax)
        self._on_device = {}

    def stft(self, audio):
        """(B, T) -> (B, 1 + n_fft/2, n_frames) complex spectrum."""
        window = on_device(self._on_device, ("window", audio.device),
                           lambda: torch.as_tensor(self.window,
                                                   device=audio.device))
        frames = _frame_signal(audio, self.filter_length, self.hop_length)
        return torch.fft.rfft(frames * window, dim=-1).transpose(1, 2)

    def magnitude(self, audio):
        """(B, T) in [-1, 1] -> (B, 1 + n_fft/2, n_frames) magnitudes."""
        return self.stft(audio).abs()

    def __call__(self, audio):
        """(B, T) in [-1, 1] -> (B, n_mel_channels, n_frames) log-mel."""
        return self.mel_from_magnitude(self.magnitude(audio))

    def mel_from_magnitude(self, magnitudes):
        dev = magnitudes.device
        basis = on_device(self._on_device, ("basis", dev),
                          lambda: torch.as_tensor(self.mel_basis,
                                                  device=dev))
        mel = torch.einsum("mf,bft->bmt", basis, magnitudes)
        return torch.log(torch.clamp(mel, min=self.clip_val))

    def mel_numpy(self, audio):
        """audio (T,) in [-1, 1] -> (n_mel, n_frames) float32 log-mel."""
        pad = self.filter_length // 2
        x = np.pad(audio.astype(np.float64), pad, mode="reflect")
        n_frames = len(audio) // self.hop_length + 1
        stride = x.strides[0]
        frames = np.lib.stride_tricks.as_strided(
            x, (n_frames, self.filter_length),
            (self.hop_length * stride, stride), writeable=False)
        spec = np.abs(np.fft.rfft(frames * self.window[None, :], axis=-1))
        mel = self.mel_basis @ spec.T.astype(np.float32)
        return np.log(np.clip(mel, self.clip_val, None)).astype(np.float32)


def dynamic_range_compression(x, C=1, clip_val=1e-5):
    return torch.log(torch.clamp(x, min=clip_val) * C)


def dynamic_range_decompression(x, C=1):
    return torch.exp(x) / C

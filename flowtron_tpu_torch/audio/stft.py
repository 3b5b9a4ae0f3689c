"""Host log-mel spectrogram for the data pipeline (port of the numpy parts
of flowtron_tpu/audio/stft.py: ``hann_window``, ``pad_center`` and
``MelSpectrogram.mel_numpy``).

TacotronSTFT semantics (reference:audio_processing.py:96-134): reflect
padding of ``filter_length // 2`` on each side, periodic Hann window
(zero-center-padded to ``filter_length``), hop stride, ``n_frames =
T // hop + 1``, Slaney mel filterbank, log of the magnitude mel clipped at
``clip_val``. The device STFT and Griffin-Lim are ROADMAP.md deferred
item 1.
"""

import numpy as np

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


class MelSpectrogram:
    """waveform -> log-mel on the host, in numpy."""

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

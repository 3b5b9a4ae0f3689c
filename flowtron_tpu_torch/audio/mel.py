"""Mel filterbank construction (port of flowtron_tpu/audio/mel.py, pure numpy;
librosa-compatible, self-contained).

Reproduces ``librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax)`` with the
defaults the reference uses (reference:audio_processing.py:104-105):
htk=False (Slaney mel scale) and norm=1 (Slaney area normalization),
written out in numpy so that librosa is not needed.
"""

import numpy as np


def hz_to_mel(frequencies):
    """Slaney mel scale: linear below 1 kHz, log above."""
    frequencies = np.asanyarray(frequencies, dtype=np.float64)
    f_min = 0.0
    f_sp = 200.0 / 3
    mels = (frequencies - f_min) / f_sp

    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0

    if frequencies.ndim:
        log_t = frequencies >= min_log_hz
        mels[log_t] = min_log_mel + np.log(frequencies[log_t] / min_log_hz) / logstep
    elif frequencies >= min_log_hz:
        mels = min_log_mel + np.log(frequencies / min_log_hz) / logstep
    return mels


def mel_to_hz(mels):
    """Inverse of hz_to_mel."""
    mels = np.asanyarray(mels, dtype=np.float64)
    f_min = 0.0
    f_sp = 200.0 / 3
    freqs = f_min + f_sp * mels

    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0

    if mels.ndim:
        log_t = mels >= min_log_mel
        freqs[log_t] = min_log_hz * np.exp(logstep * (mels[log_t] - min_log_mel))
    elif mels >= min_log_mel:
        freqs = min_log_hz * np.exp(logstep * (mels - min_log_mel))
    return freqs


def mel_filterbank(sampling_rate, n_fft, n_mels=80, fmin=0.0, fmax=None,
                   dtype=np.float32):
    """Triangular mel filterbank, shape (n_mels, 1 + n_fft // 2)."""
    if fmax is None:
        fmax = float(sampling_rate) / 2

    n_bins = 1 + n_fft // 2
    weights = np.zeros((n_mels, n_bins), dtype=np.float64)

    fftfreqs = np.linspace(0, float(sampling_rate) / 2, n_bins)

    mel_f = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))

    fdiff = np.diff(mel_f)
    ramps = np.subtract.outer(mel_f, fftfreqs)

    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))

    # Slaney-style area normalization: each filter integrates to ~1 in Hz.
    enorm = 2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, np.newaxis]

    return weights.astype(dtype)

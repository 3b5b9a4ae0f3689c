"""WaveGlow bias denoiser (port of flowtron_tpu/vocoder/denoiser.py;
reference notebook cell 2/7, the waveglow repo's Denoiser): estimate the
vocoder's bias spectrum by vocoding a zero mel at sigma 0, then subtract
it spectrally from generated audio.

``Denoiser`` runs on the vocoder's device: its bias pass is a
``waveglow_infer`` in the vocoder's dtype (bf16 for a bf16 engine's
vocoder, as the JAX engine builds its denoiser from the cast params), so
kernel K2 on CUDA, and the subtraction is the tensor STFT and
``InverseSTFT``, in fp32. ``StreamingDenoiser`` is the host numpy
version for chunked audio, in float64 as in the JAX package.
"""

import numpy as np
import torch

from flowtron_tpu_torch.audio.griffin_lim import InverseSTFT
from flowtron_tpu_torch.audio.stft import MelSpectrogram
from flowtron_tpu_torch.vocoder.waveglow import waveglow_infer

BIAS_FRAMES = 88     # the mel frames of the bias pass


class Denoiser:
    @torch.no_grad()
    def __init__(self, wg_model, wg_config, filter_length=1024,
                 hop_length=256, win_length=1024, n_mel_channels=80):
        self.filter_length = filter_length
        self.hop_length = hop_length
        self.win_length = win_length
        self._ms = MelSpectrogram(filter_length, hop_length, win_length,
                                  n_mel_channels)
        self._istft = InverseSTFT(filter_length, hop_length, win_length)
        param = next(wg_model.parameters())
        mel = torch.zeros(1, n_mel_channels, BIAS_FRAMES, device=param.device,
                          dtype=param.dtype)
        bias_audio = waveglow_infer(wg_model, wg_config, mel,
                                    sigma=0.0).float()
        # (1, n_bins, 1): the first frame's magnitudes
        self.bias_spec = self._ms.magnitude(bias_audio)[:, :, :1]

    @classmethod
    def from_data_config(cls, wg_model, wg_config, data_config):
        """The denoiser at a data config's STFT and the vocoder's mel
        width, as the CLI and the server build it."""
        return cls(wg_model, wg_config,
                   filter_length=data_config["filter_length"],
                   hop_length=data_config["hop_length"],
                   win_length=data_config["win_length"],
                   n_mel_channels=wg_config["n_mel_channels"])

    @torch.no_grad()
    def __call__(self, audio, strength=0.1):
        """audio (B, T) -> denoised audio (B, hop * (T // hop)).
        ``strength``: a float or a (B, 1, 1) tensor of per-row
        strengths."""
        spec = self._ms.stft(audio)
        mag = torch.clamp(spec.abs() - strength * self.bias_spec, min=0.0)
        return self._istft(mag, spec.angle())


class StreamingDenoiser:
    """Chunked denoise that emits exactly the offline Denoiser's samples.

    An output sample depends only on the STFT frames overlapping it, i.e.
    on input within ``filter_length`` samples of it (plus the reflect head
    padding, fixed after the first chunk, and the reflect tail padding,
    known only at the end). Frames are spectrally subtracted as soon as
    their full support has arrived, accumulated into overlap-add and
    window-sumsquare buffers, and a sample is emitted once every frame
    overlapping it is in, so the concatenation of all ``feed()`` outputs
    plus ``flush()`` equals ``Denoiser()(full_audio)`` up to float32 (the
    card) against float64 (here) rounding. The live edge lags the input
    by at most ``filter_length`` samples (~46 ms at 22.05 kHz).

    Host numpy: a chunk is a few thousand samples, and the stream's audio
    is on the host already.
    """

    def __init__(self, denoiser, strength=0.1):
        self._fl = denoiser.filter_length
        self._hop = denoiser.hop_length
        self._pad = self._fl // 2
        self._win = np.asarray(denoiser._ms.window, np.float64)
        self._win_sq = self._win ** 2
        self._bias = denoiser.bias_spec.double().cpu().numpy()[0, :, 0]
        self._strength = float(strength)
        self._reset()

    def _reset(self):
        self._audio = np.zeros(0, np.float64)
        self._next_frame = 0
        self._ola = np.zeros(0, np.float64)
        self._wss = np.zeros(0, np.float64)
        self._emit_p = self._pad  # next padded coordinate to emit

    def feed(self, chunk):
        """Append samples; return newly-finalized denoised samples."""
        chunk = np.asarray(chunk, np.float64).reshape(-1)
        if chunk.size:
            self._audio = np.concatenate([self._audio, chunk])
        return self._advance(last=False)

    def flush(self):
        """End of stream: emit the remaining tail and reset."""
        out = self._advance(last=True)
        self._reset()
        return out

    def _advance(self, last):
        n, pad, hop, fl = len(self._audio), self._pad, self._hop, self._fl
        if n == 0:
            return np.zeros(0, np.float32)
        # reflect padding (the offline convention) needs > pad samples
        mode = "reflect" if n > pad else "constant"
        if last:
            x = np.pad(self._audio, pad, mode=mode)
            nf = n // hop + 1
            need = nf * hop + (fl - hop)
            if len(x) < need:  # offline _frame_signal zero-pads the tail
                x = np.pad(x, (0, need - len(x)))
            hi = nf
        else:
            if n <= pad:
                return np.zeros(0, np.float32)
            x = np.pad(self._audio, (pad, 0), mode="reflect")
            # frames whose support is fully inside the received samples
            # (anything further would read the yet-unknown tail padding)
            hi = (n + pad - fl) // hop + 1
        lo = self._next_frame
        if hi > lo:
            idx = (np.arange(lo, hi)[:, None] * hop
                   + np.arange(fl)[None, :])
            spec = np.fft.rfft(x[idx] * self._win[None, :], axis=-1)
            mag = np.clip(np.abs(spec)
                          - self._strength * self._bias[None, :],
                          0.0, None)
            rec = np.fft.irfft(mag * np.exp(1j * np.angle(spec)), n=fl,
                               axis=-1) * self._win[None, :]
            end = (hi - 1) * hop + fl
            if len(self._ola) < end:
                grow = end - len(self._ola)
                self._ola = np.pad(self._ola, (0, grow))
                self._wss = np.pad(self._wss, (0, grow))
            for k, i in enumerate(range(lo, hi)):
                self._ola[i * hop:i * hop + fl] += rec[k]
                self._wss[i * hop:i * hop + fl] += self._win_sq
            self._next_frame = hi
        if last:
            # offline trims filter_length//2 from both ends
            total = fl + hop * (self._next_frame - 1)
            emit_to = max(self._emit_p, total - pad)
        else:
            # padded coord p is final once every overlapping frame
            # (i*hop <= p < i*hop+fl) has been accumulated
            emit_to = self._next_frame * hop
        emit_to = min(emit_to, len(self._ola))
        if emit_to <= self._emit_p:
            return np.zeros(0, np.float32)
        seg = slice(self._emit_p, emit_to)
        tiny = np.finfo(np.float32).tiny
        norm = np.where(self._wss[seg] > tiny, self._wss[seg], 1.0)
        out = (self._ola[seg] / norm).astype(np.float32)
        self._emit_p = emit_to
        return out

"""Dataset: filelist -> (mel, speaker_id, text ids, attention prior)
(port of ``Data`` and ``data_kwargs`` in flowtron_tpu/data/dataset.py;
reference:data.py:59-188).

Host-side numpy end to end: the wav is read with scipy, the log-mel comes
from the port's numpy ``MelSpectrogram`` (with ``use_native``, both come
from the port's C++ library, ``native/``, built at first use; if it cannot
be built the reason is printed and numpy runs, as in the JAX package,
since the two agree within 1e-5), the text from the port's text
package through ``data/frontend.py:TextFrontend`` (same filelist shuffle
and ARPAbet draws from one ``random.Random(seed)``), the prior from
``data/prior.py``. The prior disk cache is on only at ``p_arpabet ==
1.0``; an optional mel cache keeps one ``.npy`` per wav. Batching is
``data/collate.py``.
"""

import inspect
import os
import uuid

import numpy as np
from scipy.io import wavfile

from flowtron_tpu_torch.audio.stft import MelSpectrogram
from flowtron_tpu_torch.data.frontend import TextFrontend
from flowtron_tpu_torch.data.prior import beta_binomial_prior


def _atomic_save_npy(path, arr):
    """Write-then-rename, so a reader never sees a half-written file."""
    tmp = f"{path}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp.npy"
    with open(tmp, "wb") as f:
        np.save(f, arr)
    os.replace(tmp, path)


def _load_cached_npy(path):
    """None on a miss or on a corrupt file (which is then recomputed)."""
    if not os.path.exists(path):
        return None
    try:
        return np.load(path)
    except (ValueError, EOFError, OSError):
        return None


def load_wav(full_path):
    """Returns (float32 waveform in native integer scale, sampling_rate)."""
    sampling_rate, data = wavfile.read(full_path)
    return data.astype(np.float32), sampling_rate


# data_config keys consumed by other layers, not Data.__init__
_NON_DATA_KEYS = frozenset({
    "training_files", "validation_files", "use_grain", "grain_workers",
})


def data_kwargs(data_config, exclude=("training_files", "validation_files")):
    """Filter a data_config dict down to ``Data.__init__``'s parameters;
    a key that is neither a parameter nor a known loader key raises."""
    valid = set(inspect.signature(Data.__init__).parameters)
    valid -= {"self", "filelist_path"}
    unknown = set(data_config) - valid - _NON_DATA_KEYS
    if unknown:
        raise TypeError(f"unknown data_config key(s): {sorted(unknown)} — "
                        "not a Data parameter or loader option")
    return {k: v for k, v in data_config.items()
            if k in valid and k not in exclude}


class Data(TextFrontend):
    """Map-style dataset over a filelist."""

    def __init__(self, filelist_path, filter_length=1024, hop_length=256,
                 win_length=1024, sampling_rate=22050, mel_fmin=0.0,
                 mel_fmax=8000.0, max_wav_value=32768.0, p_arpabet=0.5,
                 cmudict_path="", heteronyms_path="", text_cleaners=None,
                 speaker_ids=None, use_attn_prior=False,
                 attn_prior_threshold=1e-4, prior_cache_path="",
                 betab_scaling_factor=1.0, randomize=True,
                 keep_ambiguous=False, seed=1234, mel_cache_path="",
                 use_native=False):
        super().__init__(filelist_path, p_arpabet=p_arpabet,
                         cmudict_path=cmudict_path,
                         heteronyms_path=heteronyms_path,
                         text_cleaners=text_cleaners,
                         speaker_ids=speaker_ids,
                         keep_ambiguous=keep_ambiguous, seed=seed,
                         randomize=randomize)
        self.max_wav_value = max_wav_value
        self.use_attn_prior = use_attn_prior
        self.betab_scaling_factor = betab_scaling_factor
        self.attn_prior_threshold = attn_prior_threshold
        self.sampling_rate = sampling_rate
        self.stft = MelSpectrogram(
            filter_length=filter_length, hop_length=hop_length,
            win_length=win_length, sampling_rate=sampling_rate,
            mel_fmin=mel_fmin, mel_fmax=mel_fmax)
        # text lengths are deterministic only without ARPAbet draws
        self.prior_cache_path = prior_cache_path
        self.caching_enabled = bool(prior_cache_path) and p_arpabet == 1.0
        if self.caching_enabled:
            os.makedirs(prior_cache_path, exist_ok=True)
        self.mel_cache_path = mel_cache_path
        if mel_cache_path:
            os.makedirs(mel_cache_path, exist_ok=True)
        # the native (C++) wav decode and mel (flowtron_tpu/data/
        # dataset.py:141-152)
        self._native_mel = None
        self._native_decode = None
        if use_native:
            try:
                from flowtron_tpu_torch import native
                if native.available() or native.build():
                    self._native_mel = native.NativeMel(
                        self.stft.window, self.stft.mel_basis,
                        filter_length, hop_length)
                    self._native_decode = native.decode_wav
            except (OSError, RuntimeError) as e:
                print(f"native data path unavailable ({e}); using numpy")

    def compute_attention_prior(self, audiopath, mel_length, text_length):
        prior_path = None
        if self.caching_enabled:
            folder = audiopath.split("/")[-2] if "/" in audiopath else ""
            fname = os.path.basename(audiopath).split(".")[0]
            prior_path = os.path.join(self.prior_cache_path,
                                      f"{folder}_{fname}_prior.npy")
            cached = _load_cached_npy(prior_path)
            if cached is not None and cached.shape == (mel_length,
                                                       text_length):
                if self.attn_prior_threshold > 0:
                    cached = np.where(cached < self.attn_prior_threshold,
                                      0.0, cached)
                return cached
        attn_prior = beta_binomial_prior(text_length, mel_length,
                                         self.betab_scaling_factor)
        if prior_path is not None:
            _atomic_save_npy(prior_path, attn_prior)
        if self.attn_prior_threshold > 0:
            attn_prior = np.where(attn_prior < self.attn_prior_threshold,
                                  0.0, attn_prior)
        return attn_prior

    def get_mel(self, audio):
        """audio: float32 waveform in integer scale -> (80, T) log-mel."""
        audio_norm = audio / self.max_wav_value
        if self._native_mel is not None:
            return self._native_mel(audio_norm)
        return self.stft.mel_numpy(audio_norm)

    def _load_mel_cached(self, audiopath, audio):
        if not self.mel_cache_path:
            return self.get_mel(audio)
        fname = audiopath.replace("/", "_").replace("\\", "_") + ".npy"
        path = os.path.join(self.mel_cache_path, fname)
        cached = _load_cached_npy(path)
        if cached is not None:
            return cached
        mel = self.get_mel(audio)
        _atomic_save_npy(path, mel)
        return mel

    def __getitem__(self, index):
        audiopath, text, speaker_id = self.audiopaths_and_text[index]
        audio, sampling_rate = (self._native_decode or load_wav)(audiopath)
        if sampling_rate != self.sampling_rate:
            raise ValueError(f"{sampling_rate} SR doesn't match target "
                             f"{self.sampling_rate} SR")
        mel = self._load_mel_cached(audiopath, audio)
        text_encoded = self.get_text(text)
        speaker_id = self.get_speaker_id(speaker_id)
        attn_prior = None
        if self.use_attn_prior:
            attn_prior = self.compute_attention_prior(
                audiopath, mel.shape[1], text_encoded.shape[0])
        return mel, speaker_id, text_encoded, attn_prior

    def __len__(self):
        return len(self.audiopaths_and_text)

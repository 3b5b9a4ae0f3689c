"""Alignment-learnable synthetic speech corpus (port of
flowtron_tpu/data/synth.py, pure numpy and scipy).

The reference's training recipe needs hours of recorded speech
(reference:README.md:16-40) that a hermetic container cannot ship. The
earlier tonal smoke corpora exercised the data pipeline and loss
plumbing, but their audio was *text-independent* — attention alignment
was unlearnable in principle, so "training converges" could only mean
"the NLL drops".

This corpus closes that gap as far as synthetic audio can: every text
character is rendered as a distinct harmonic tone segment (a chromatic
f0 scale plus a per-character harmonic-amplitude signature) with a
randomized duration, concatenated in text order. The mel frames of an
utterance therefore *monotonically encode the character sequence*, so a
model trained on it must learn exactly what Flowtron learns from
speech: a monotone text↔mel alignment (visible as diagonal attention,
reference:README.md:37-40) and an end-of-utterance gate. The generator
also returns the ground-truth segment spans, giving tests an oracle
alignment to score against.

Filelist format matches the reference loader (reference:data.py:44-56):
``wav_path|transcript|speaker_id``.
"""

import os

import numpy as np

_SR_DEFAULT = 22050

# consonant/vowel pools for pronounceable random words (letters only,
# so flowtron_cleaners is an identity modulo case and the cleaned text
# equals the transcript — tests rely on that 1:1 symbol correspondence)
_CONSONANTS = "bdfgklmnprstvz"
_VOWELS = "aeiou"


def _char_timbre(c):
    """(f0_hz, harmonic amplitudes) for one lowercase letter: a unique,
    mel-distinguishable tone per character. f0 walks a chromatic scale
    (110-465 Hz over a-z); two upper harmonics carry a per-character
    amplitude signature so letters a semitone apart still differ in
    timbre, not just pitch."""
    idx = ord(c) - ord("a")
    f0 = 110.0 * 2.0 ** (idx / 12.0)
    a2 = 0.2 + 0.6 * ((idx * 5) % 7) / 7.0
    a3 = 0.2 + 0.6 * ((idx * 3) % 11) / 11.0
    return f0, (1.0, a2, a3)


def synth_utterance(text, sr=_SR_DEFAULT, seed=0, pitch_shift=1.0,
                    char_ms=(55.0, 110.0), space_ms=(60.0, 90.0)):
    """Render `text` (lowercase letters + single spaces) to audio.

    Returns ``(wave, spans)``: a float waveform in [-1, 1] and one
    ``(char, start_sample, end_sample)`` triple per character of
    `text` *including spaces* — the ground-truth alignment. Durations
    are drawn per character from ``char_ms`` (uniform, milliseconds);
    `pitch_shift` scales every f0 (a per-speaker "style").
    """
    rng = np.random.default_rng(seed)
    pieces, spans = [], []
    pos = 0
    ramp = int(0.005 * sr)
    for c in text:
        if c == " ":
            n = int(rng.uniform(*space_ms) * 1e-3 * sr)
            seg = np.zeros(n)
        else:
            f0, amps = _char_timbre(c)
            n = int(rng.uniform(*char_ms) * 1e-3 * sr)
            t = np.arange(n) / sr
            seg = np.zeros(n)
            for h, a in enumerate(amps):
                seg += a * np.sin(2 * np.pi * f0 * pitch_shift
                                  * (h + 1) * t)
            env = np.ones(n)
            env[:ramp] = 0.5 - 0.5 * np.cos(
                np.pi * np.arange(ramp) / ramp)
            env[-ramp:] = env[:ramp][::-1]
            seg *= env
        pieces.append(seg)
        spans.append((c, pos, pos + n))
        pos += n
    wave = np.concatenate(pieces)
    peak = np.abs(wave).max()
    if peak > 0:
        wave = wave / peak * 0.7
    wave = wave + 0.003 * rng.standard_normal(len(wave))
    return wave, spans


def random_text(rng, n_words=(3, 8), n_syllables=(1, 3)):
    """A pronounceable random transcript: CV-syllable words."""
    words = []
    for _ in range(int(rng.integers(n_words[0], n_words[1] + 1))):
        syl = [rng.choice(list(_CONSONANTS)) + rng.choice(list(_VOWELS))
               for _ in range(int(rng.integers(n_syllables[0],
                                               n_syllables[1] + 1)))]
        words.append("".join(syl))
    return " ".join(words)


def make_aligned_corpus(root, n_utterances=48, n_speakers=1, seed=0,
                        sr=_SR_DEFAULT, val_count=0):
    """Write `n_utterances` coded-tone wavs + filelist(s) under `root`.

    Speakers differ by a global pitch shift (2^(s/8)). Returns
    ``(train_filelist, val_filelist)``; `val_filelist` is None when
    ``val_count == 0``. Deterministic in `seed`.
    """
    from scipy.io import wavfile
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    lines = []
    for u in range(n_utterances):
        sid = u % n_speakers
        text = random_text(rng)
        wave, _ = synth_utterance(text, sr=sr,
                                  seed=int(rng.integers(2 ** 31)),
                                  pitch_shift=2.0 ** (sid / 8.0))
        path = os.path.join(root, f"utt{u:04d}.wav")
        wavfile.write(path, sr, (wave * 25000).astype(np.int16))
        lines.append(f"{path}|{text}|{sid}")
    val = lines[:val_count]
    train = lines[val_count:]
    train_fl = os.path.join(root, "train_filelist.txt")
    with open(train_fl, "w") as f:
        f.write("\n".join(train) + "\n")
    val_fl = None
    if val:
        val_fl = os.path.join(root, "val_filelist.txt")
        with open(val_fl, "w") as f:
            f.write("\n".join(val) + "\n")
    return train_fl, val_fl

"""Text frontend: text -> symbol ids, speaker id -> dense index.

Carries the text half of ``flowtron_tpu.data.dataset.Data``
(``get_text`` and ``get_speaker_id``, flowtron_tpu/data/dataset.py:209-223)
over the port's own copy of the text package (``flowtron_tpu_torch.text``,
a copy of ``flowtron_tpu/text/`` with only its imports changed). The random
stream is the same ``random.Random(seed)``, including the filelist shuffle
that comes before any ARPAbet draw, so both packages give the same ids for
the same data config.
"""

import random
import re

import numpy as np

from flowtron_tpu_torch.text import (
    _clean_text, get_arpabet, set_heteronyms_path, text_to_sequence,
)
from flowtron_tpu_torch.text import cleaners as _cleaners
from flowtron_tpu_torch.text.cmudict import CMUDict


def _load_filelist(path, split="|"):
    with open(path, encoding="utf-8") as f:
        return [line.strip().split(split) for line in f]


class TextFrontend:
    """``Data``'s text and speaker handling, without audio (the port's
    ``data/dataset.py:Data`` adds the audio). ``audiopaths_and_text``
    holds the filelist in the order the seeded shuffle left it."""

    def __init__(self, filelist_path, p_arpabet=0.5, cmudict_path="",
                 heteronyms_path="", text_cleaners=None, speaker_ids=None,
                 keep_ambiguous=False, seed=1234, randomize=True):
        entries = _load_filelist(filelist_path)
        if speaker_ids is None or speaker_ids == "":
            ids = np.sort(np.unique([e[2] for e in entries]))
            speaker_ids = {int(ids[i]): i for i in range(len(ids))}
        self.speaker_ids = speaker_ids
        self.audiopaths_and_text = entries
        self.text_cleaners = text_cleaners or ["flowtron_cleaners"]
        self.p_arpabet = p_arpabet
        self.cmudict = (CMUDict(cmudict_path, keep_ambiguous=keep_ambiguous)
                        if cmudict_path else None)
        _cleaners.set_acronym_cmudict(self.cmudict)
        if heteronyms_path:
            set_heteronyms_path(heteronyms_path)
        self._rand = random.Random(seed)
        if randomize:
            # Data shuffles its filelist with the same generator first
            self._rand.shuffle(entries)

    @classmethod
    def from_config(cls, data_config):
        """Build from a config's ``data_config`` section."""
        keys = ("p_arpabet", "cmudict_path", "heteronyms_path",
                "text_cleaners", "speaker_ids", "keep_ambiguous", "seed")
        return cls(data_config["training_files"],
                   **{k: data_config[k] for k in keys if k in data_config})

    def get_speaker_id(self, speaker_id):
        return np.int64(self.speaker_ids[int(speaker_id)])

    def get_text(self, text):
        text = _clean_text(text, self.text_cleaners)
        words = re.findall(r"\S*\{.*?\}\S*|\S+", text)
        if self.cmudict is not None:
            text = " ".join(
                get_arpabet(word, self.cmudict)
                if self._rand.random() < self.p_arpabet else word
                for word in words)
        else:
            text = " ".join(words)
        return np.asarray(text_to_sequence(text), np.int64)

"""Text ids as the served model derives them, without the program.

The server's frontend (``flowtron_tpu_torch/data/frontend.py``) cleans the
text with the config's cleaners, splits it into words and, with
``p_arpabet`` 0, joins them back before mapping symbols to ids; the
CMU dictionary is still read, for the acronym cleaner. This is that rule
over the frozen copy of the text package in ``reference/text``.
"""

import re

import numpy as np

from benchmark.reference.text import _clean_text, text_to_sequence
from benchmark.reference.text import cleaners as _cleaners
from benchmark.reference.text.cmudict import CMUDict


class TextIds:
    """``ids(text)``: the int64 symbol ids of ``text`` under a data config
    whose ``p_arpabet`` is 0."""

    def __init__(self, data_config):
        if float(data_config.get("p_arpabet", 0.0)) != 0.0:
            raise ValueError("the reference derives ids for p_arpabet 0 "
                             "only (ARPAbet draws are random)")
        self.cleaners = data_config.get("text_cleaners",
                                        ["flowtron_cleaners"])
        path = data_config.get("cmudict_path", "")
        self.cmudict = CMUDict(
            path, keep_ambiguous=data_config.get("keep_ambiguous", False)) \
            if path else None

    def ids(self, text):
        _cleaners.set_acronym_cmudict(self.cmudict)
        text = _clean_text(text, self.cleaners)
        words = re.findall(r"\S*\{.*?\}\S*|\S+", text)
        return np.asarray(text_to_sequence(" ".join(words)), np.int64)


def speaker_table(filelist_path):
    """The server's speaker map: the filelist's unique speaker ids, sorted
    as strings (NVIDIA/flowtron's ``Data.create_speaker_lookup_table``
    sorts them so: "1034" before "118"), -> dense index."""
    with open(filelist_path, encoding="utf-8") as f:
        sids = sorted({line.strip().split("|")[2] for line in f
                       if line.strip()})
    return {int(s): i for i, s in enumerate(sids)}

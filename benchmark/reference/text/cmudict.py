"""CMU pronouncing dictionary loader.

Parses the standard CMUdict text format (one ``WORD  PH ON EMES`` entry per
line, alternates marked ``WORD(1)``). Behavior mirrors the reference loader
(reference:text/cmudict.py:19-65): entries whose pronunciation contains an
out-of-inventory symbol are dropped, and with ``keep_ambiguous=False`` any
word with more than one pronunciation is removed entirely.
"""

import re

# The 39-phoneme ARPAbet inventory with 0/1/2 stress variants on vowels.
_VOWELS = [
    "AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY",
    "IH", "IY", "OW", "OY", "UH", "UW",
]
_CONSONANTS = [
    "B", "CH", "D", "DH", "F", "G", "HH", "JH", "K", "L", "M", "N", "NG",
    "P", "R", "S", "SH", "T", "TH", "V", "W", "Y", "Z", "ZH",
]

# Ordering matches the reference inventory (reference:text/cmudict.py:6-14):
# each vowel appears as base, 0, 1, 2; consonants interleaved alphabetically.
VALID_SYMBOLS = sorted(
    [v + s for v in _VOWELS for s in ("", "0", "1", "2")] + _CONSONANTS
)

_VALID_SYMBOL_SET = set(VALID_SYMBOLS)

_ALT_RE = re.compile(r"\([0-9]+\)")


class CMUDict:
    """Word -> list-of-pronunciations lookup over a CMUdict-format file."""

    def __init__(self, file_or_path, keep_ambiguous=True):
        if isinstance(file_or_path, str):
            with open(file_or_path, encoding="latin-1") as f:
                entries = _parse_cmudict(f)
        else:
            entries = _parse_cmudict(file_or_path)
        if not keep_ambiguous:
            entries = {w: p for w, p in entries.items() if len(p) == 1}
        self._entries = entries

    def __len__(self):
        return len(self._entries)

    def lookup(self, word):
        """Return the list of ARPAbet pronunciations for ``word`` or None."""
        return self._entries.get(word.upper())


def _parse_cmudict(file):
    entries = {}
    for line in file:
        if len(line) and ("A" <= line[0] <= "Z" or line[0] == "'"):
            parts = line.split("  ")
            if len(parts) < 2:
                continue
            word = _ALT_RE.sub("", parts[0])
            pron = _validate_pronunciation(parts[1])
            if pron:
                entries.setdefault(word, []).append(pron)
    return entries


def _validate_pronunciation(s):
    parts = s.strip().split(" ")
    for part in parts:
        if part not in _VALID_SYMBOL_SET:
            return None
    return " ".join(parts)

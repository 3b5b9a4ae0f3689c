"""Acronym expansion: "NASA" -> CMUdict lookup or letter-by-letter ARPAbet.

Mirrors reference:text/acronyms.py:35-65, but takes the dictionary as an
argument (lazily shared with the frontend) instead of loading a module-level
copy from a hard-coded relative path.
"""

import re

_LETTER_TO_ARPABET = {
    "A": "EY1",
    "B": "B IY1",
    "C": "S IY1",
    "D": "D IY1",
    "E": "IY1",
    "F": "EH1 F",
    "G": "JH IY1",
    "H": "EY1 CH",
    "I": "AY1",
    "J": "JH EY1",
    "K": "K EY1",
    "L": "EH1 L",
    "M": "EH1 M",
    "N": "EH1 N",
    "O": "OW1",
    "P": "P IY1",
    "Q": "K Y UW1",
    "R": "AA1 R",
    "S": "EH1 S",
    "T": "T IY1",
    "U": "Y UW1",
    "V": "V IY1",
    "X": "EH1 K S",
    "Y": "W AY1",
    "W": "D AH1 B AH0 L Y UW0",
    "Z": "Z IY1",
    "s": "Z",
}

# Two-or-more capitals, optionally plural, or dotted forms like "U.S.".
_acronym_re = re.compile(r"([A-Z][A-Z]+)s?|([A-Z]\.([A-Z]\.)+s?)")


def _expand_acronym(acronym, cmu):
    acronym = re.sub(r"\.", "", acronym)
    acronym = "".join(acronym.split())
    arpabet = cmu.lookup(acronym) if cmu is not None else None

    if arpabet is None:
        letters = list(acronym)
        arpabet = ["{" + _LETTER_TO_ARPABET[c] + "}" for c in letters]
        # Fold a trailing plural 'Z' into the previous phoneme group.
        if arpabet[-1] == "{Z}" and len(arpabet) > 1:
            arpabet[-2] = arpabet[-2][:-1] + " " + arpabet[-1][1:]
            del arpabet[-1]
        return " ".join(arpabet)
    return "{" + arpabet[0] + "}"


def normalize_acronyms(text, cmu=None):
    return re.sub(_acronym_re, lambda m: _expand_acronym(m.group(0), cmu), text)

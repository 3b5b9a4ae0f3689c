"""Text frontend: string -> integer id sequence over the 185-symbol table.

A frozen copy of the port's ``flowtron_tpu_torch/text`` package (itself a
copy of the reference's ``text/``), only its imports made relative, so the
benchmark's reference derives text ids without importing the program.

Public surface mirrors the reference (reference:text/__init__.py:17-107):
``text_to_sequence`` / ``sequence_to_text`` with curly-brace ARPAbet segments,
``get_arpabet`` per-word phonemization with heteronym skipping and possessive
's -> Z handling, and ``_clean_text`` dispatch over named cleaner pipelines.

Unlike the reference, heteronyms are loaded lazily from a configurable path
(``set_heteronyms_path``) instead of a hard-coded relative file.
"""

import re

from . import cleaners
from .symbols import symbols
from .cmudict import CMUDict  # noqa: F401  (public re-export)

_symbol_to_id = {s: i for i, s in enumerate(symbols)}
_id_to_symbol = {i: s for i, s in enumerate(symbols)}

# Text enclosed in curly braces is treated as ARPAbet.
_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")

# Words containing an apostrophe (for possessive handling).
_apostrophe = re.compile(r"(?=\S*['])([a-zA-Z'-]+)")

_heteronyms = None
_heteronyms_path = None


def set_heteronyms_path(path):
    """Point the frontend at a heteronyms word list (one word per line)."""
    global _heteronyms, _heteronyms_path
    _heteronyms_path = path
    _heteronyms = None


def get_heteronyms():
    global _heteronyms
    if _heteronyms is None:
        if _heteronyms_path is None:
            _heteronyms = frozenset()
        else:
            with open(_heteronyms_path, encoding="utf-8") as f:
                _heteronyms = frozenset(line.rstrip() for line in f)
    return _heteronyms


def text_to_sequence(text):
    """Convert a string (optionally with {ARPAbet} segments) to symbol ids."""
    sequence = []
    while len(text):
        m = _curly_re.match(text)
        if not m:
            sequence += _symbols_to_sequence(text)
            break
        sequence += _symbols_to_sequence(m.group(1))
        sequence += _arpabet_to_sequence(m.group(2))
        text = m.group(3)
    return sequence


def sequence_to_text(sequence):
    """Inverse of text_to_sequence (ARPAbet re-wrapped in curly braces)."""
    result = ""
    for symbol_id in sequence:
        if symbol_id in _id_to_symbol:
            s = _id_to_symbol[symbol_id]
            if len(s) > 1 and s[0] == "@":
                s = "{%s}" % s[1:]
            result += s
    return result.replace("}{", " ")


def _clean_text(text, cleaner_names):
    for name in cleaner_names:
        cleaner = getattr(cleaners, name, None)
        if cleaner is None:
            raise ValueError("Unknown cleaner: %s" % name)
        text = cleaner(text)
    return text


def _symbols_to_sequence(syms):
    return [_symbol_to_id[s] for s in syms if _should_keep_symbol(s)]


def _arpabet_to_sequence(text):
    return _symbols_to_sequence(["@" + s for s in text.split()])


def _should_keep_symbol(s):
    return s in _symbol_to_id and s != "_" and s != "~"


def get_arpabet(word, cmu, index=0):
    """Replace a word with its {ARPAbet} pronunciation when unambiguous.

    Strips leading/trailing punctuation, converts possessive 's to a Z
    phoneme suffix, and leaves heteronyms as plain text.
    """
    start_symbols = re.findall(r"\A\W+", word)
    if len(start_symbols):
        start_symbols = start_symbols[0]
        word = word[len(start_symbols):]
    else:
        start_symbols = ""

    end_symbols = re.findall(r"\W+\Z", word)
    if len(end_symbols):
        end_symbols = end_symbols[0]
        word = word[:-len(end_symbols)]
    else:
        end_symbols = ""

    arpabet_suffix = ""
    if (_apostrophe.match(word) is not None and word.lower() != "it's"
            and word.lower()[-1] == "s"):
        word = word[:-2]
        arpabet_suffix = " Z"
    arpabet = None if word.lower() in get_heteronyms() else cmu.lookup(word)

    if arpabet is not None:
        return start_symbols + "{%s}" % (arpabet[index] + arpabet_suffix) + end_symbols
    return start_symbols + word + end_symbols


def files_to_list(filename):
    """Read a text file into a list of stripped lines."""
    with open(filename, encoding="utf-8") as f:
        return [line.rstrip() for line in f.readlines()]

"""Text cleaner pipelines.

The primary pipeline is ``flowtron_cleaners`` (reference:text/cleaners.py:114-121):
collapse whitespace -> remove intra-word hyphens -> dates/times -> numbers ->
safe abbreviations ("No.") -> acronyms. Note it does NOT lowercase or
transliterate. ``basic``/``transliteration``/``english`` variants are kept
for config compatibility; transliteration falls back to a unicodedata-based
ASCII fold since the unidecode package is unavailable.
"""

import re
import unicodedata

from .numbers import normalize_numbers
from .acronyms import normalize_acronyms
from .datestime import normalize_datestime

_whitespace_re = re.compile(r"\s+")

_abbreviations = [
    (re.compile(r"\b%s\." % x[0], re.IGNORECASE), x[1]) for x in [
        ("mrs", "misess"),
        ("ms", "miss"),
        ("mr", "mister"),
        ("dr", "doctor"),
        ("st", "saint"),
        ("co", "company"),
        ("jr", "junior"),
        ("maj", "major"),
        ("gen", "general"),
        ("drs", "doctors"),
        ("rev", "reverend"),
        ("lt", "lieutenant"),
        ("hon", "honorable"),
        ("sgt", "sergeant"),
        ("capt", "captain"),
        ("esq", "esquire"),
        ("ltd", "limited"),
        ("col", "colonel"),
        ("ft", "fort"),
    ]
]

_safe_abbreviations = [
    (re.compile(r"\b%s\." % x[0], re.IGNORECASE), x[1]) for x in [
        ("no", "number"),
    ]
]

# Shared CMUdict used by acronym expansion; injected by the frontend.
_acronym_cmudict = None


def set_acronym_cmudict(cmu):
    global _acronym_cmudict
    _acronym_cmudict = cmu


def expand_abbreviations(text):
    for regex, replacement in _abbreviations:
        text = re.sub(regex, replacement, text)
    return text


def expand_safe_abbreviations(text):
    for regex, replacement in _safe_abbreviations:
        text = re.sub(regex, replacement, text)
    return text


def expand_numbers(text):
    return normalize_numbers(text)


def expand_acronyms(text):
    return normalize_acronyms(text, _acronym_cmudict)


def expand_datestime(text):
    return normalize_datestime(text)


def lowercase(text):
    return text.lower()


def collapse_whitespace(text):
    return re.sub(_whitespace_re, " ", text)


def separate_acronyms(text):
    text = re.sub(r"([0-9]+)([a-zA-Z]+)", r"\1 \2", text)
    text = re.sub(r"([a-zA-Z]+)([0-9]+)", r"\1 \2", text)
    return text


def remove_hyphens(text):
    return re.sub(r"(?<=\w)(-)(?=\w)", " ", text)


# First-party unidecode stand-in (reference:text/cleaners.py:16 uses the
# unidecode package, unavailable here). NFKD strips accents (é -> e); this
# table transliterates what NFKD cannot decompose: Latin ligatures/letters,
# Greek, Cyrillic, and common punctuation/symbols. Unmapped scripts (CJK,
# Arabic, ...) are dropped — documented divergence from unidecode, which
# carries full per-script tables.
_TRANSLIT = {
    # Latin letters without NFKD decompositions
    "ß": "ss", "ẞ": "SS", "æ": "ae", "Æ": "AE", "œ": "oe", "Œ": "OE",
    "ø": "o", "Ø": "O", "ð": "d", "Ð": "D", "þ": "th", "Þ": "Th",
    "đ": "d", "Đ": "D", "ħ": "h", "Ħ": "H", "ı": "i", "ł": "l", "Ł": "L",
    "ŋ": "ng", "Ŋ": "NG", "ĸ": "k", "ſ": "s",
    # punctuation / symbols
    "–": "-", "—": "--", "―": "-", "‐": "-", "‑": "-", "−": "-",
    "‘": "'", "’": "'", "‚": ",", "“": '"', "”": '"', "„": '"',
    "«": '"', "»": '"', "‹": "'", "›": "'", "…": "...", "•": "*",
    "·": ".", "¡": "!", "¿": "?", "§": "SS", "¶": "P", "†": "+",
    "°": "deg", "µ": "u", "×": "x", "÷": "/", "±": "+-",
    "©": "(c)", "®": "(r)", "™": "(tm)",
    "€": "EUR", "£": "PS", "¥": "Y=", "¢": "C/",
    # Greek
    "α": "a", "β": "b", "γ": "g", "δ": "d", "ε": "e", "ζ": "z",
    "η": "e", "θ": "th", "ι": "i", "κ": "k", "λ": "l", "μ": "m",
    "ν": "n", "ξ": "x", "ο": "o", "π": "p", "ρ": "r", "σ": "s",
    "ς": "s", "τ": "t", "υ": "u", "φ": "ph", "χ": "kh", "ψ": "ps",
    "ω": "o",
    "Α": "A", "Β": "B", "Γ": "G", "Δ": "D", "Ε": "E", "Ζ": "Z",
    "Η": "E", "Θ": "Th", "Ι": "I", "Κ": "K", "Λ": "L", "Μ": "M",
    "Ν": "N", "Ξ": "X", "Ο": "O", "Π": "P", "Ρ": "R", "Σ": "S",
    "Τ": "T", "Υ": "U", "Φ": "Ph", "Χ": "Kh", "Ψ": "Ps", "Ω": "O",
    # Cyrillic
    "а": "a", "б": "b", "в": "v", "г": "g", "д": "d", "е": "e",
    "ж": "zh", "з": "z", "и": "i", "й": "i", "к": "k", "л": "l",
    "м": "m", "н": "n", "о": "o", "п": "p", "р": "r", "с": "s",
    "т": "t", "у": "u", "ф": "f", "х": "kh", "ц": "ts", "ч": "ch",
    "ш": "sh", "щ": "shch", "ъ": '"', "ы": "y", "ь": "'", "э": "e",
    "ю": "yu", "я": "ya",
    "А": "A", "Б": "B", "В": "V", "Г": "G", "Д": "D", "Е": "E",
    "Ж": "Zh", "З": "Z", "И": "I", "Й": "I", "К": "K", "Л": "L",
    "М": "M", "Н": "N", "О": "O", "П": "P", "Р": "R", "С": "S",
    "Т": "T", "У": "U", "Ф": "F", "Х": "Kh", "Ц": "Ts", "Ч": "Ch",
    "Ш": "Sh", "Щ": "Shch", "Ъ": '"', "Ы": "Y", "Ь": "'", "Э": "E",
    "Ю": "Yu", "Я": "Ya",
}


def convert_to_ascii(text):
    """Transliterating ASCII fold (unidecode stand-in)."""
    decomposed = unicodedata.normalize("NFKD", text)
    return "".join(ch if ord(ch) < 128 else _TRANSLIT.get(ch, "")
                   for ch in decomposed)


def basic_cleaners(text):
    text = lowercase(text)
    text = collapse_whitespace(text)
    return text


def transliteration_cleaners(text):
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = collapse_whitespace(text)
    return text


def flowtron_cleaners(text):
    text = collapse_whitespace(text)
    text = remove_hyphens(text)
    text = expand_datestime(text)
    text = expand_numbers(text)
    text = expand_safe_abbreviations(text)
    text = expand_acronyms(text)
    return text


def english_cleaners(text):
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    text = collapse_whitespace(text)
    return text

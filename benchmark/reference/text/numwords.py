"""English number → words conversion (self-contained inflect replacement).

The reference uses the ``inflect`` package (reference:text/numbers.py:3-8).
That package is not available here, so this module implements the subset of
``inflect.engine().number_to_words`` behavior the cleaners rely on:

- cardinals with scale-group commas: 1234 -> "one thousand, two hundred and
  thirty-four" (``andword`` joins hundreds to tens within each group)
- ``andword=''`` drops the joiner: "one hundred twenty-three"
- ordinal inputs: "23rd" -> "twenty-third"
- decimal strings: "3.14" -> "three point one four"
- ``group=2`` digit-pair (year) mode with ``zero='oh'``:
  2015 -> "twenty, fifteen"; 2105 -> "twenty-one, oh five"
"""

import re

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
# Scale words, index = power of 1000.
_SCALES = [
    "", "thousand", "million", "billion", "trillion", "quadrillion",
    "quintillion", "sextillion", "septillion", "octillion", "nonillion",
]

_IRREGULAR_ORDINALS = {
    "one": "first",
    "two": "second",
    "three": "third",
    "five": "fifth",
    "eight": "eighth",
    "nine": "ninth",
    "twelve": "twelfth",
}

_ORDINAL_SUFFIX_RE = re.compile(r"(st|nd|rd|th)$", re.IGNORECASE)


def _two_digits(n):
    """0-99 -> words (no 'and', hyphen between tens and units)."""
    if n < 20:
        return _ONES[n]
    tens, units = divmod(n, 10)
    if units == 0:
        return _TENS[tens]
    return f"{_TENS[tens]}-{_ONES[units]}"


def _three_digits(n, andword):
    """0-999 -> words for one scale group."""
    hundreds, rest = divmod(n, 100)
    parts = []
    if hundreds:
        parts.append(f"{_ONES[hundreds]} hundred")
    if rest:
        if hundreds and andword:
            parts.append(andword)
        parts.append(_two_digits(rest))
    return " ".join(parts)


def _integer_to_words(n, andword="and"):
    if n == 0:
        return _ONES[0]
    if n < 0:
        return "minus " + _integer_to_words(-n, andword)
    groups = []
    values = []
    scale = 0
    while n > 0:
        n, g = divmod(n, 1000)
        if g:
            words = _three_digits(g, andword)
            if scale:
                words += " " + _SCALES[scale]
            groups.append(words)
            values.append(g)
        scale += 1
    groups.reverse()
    values.reverse()
    # inflect joins a final sub-hundred group with the andword:
    # 2001 -> "two thousand and one"
    if len(groups) > 1 and values[-1] < 100 and andword:
        return ", ".join(groups[:-1]) + f" {andword} " + groups[-1]
    return ", ".join(groups)


def _digit_words(digits, zero="zero"):
    return " ".join(zero if d == "0" else _ONES[int(d)] for d in digits)


def _group2_words(digits, zero="zero", andword="and"):
    """inflect group=2 mode: digit pairs from the left, comma-joined."""
    pairs = []
    i = len(digits) % 2
    if i:
        pairs.append(digits[:i])
    pairs.extend(digits[j:j + 2] for j in range(i, len(digits), 2))

    words = []
    for p in pairs:
        if len(p) == 1:
            words.append(zero if p == "0" else _ONES[int(p)])
        elif p == "00":
            words.append(f"{zero} {zero}")
        elif p[0] == "0":
            words.append(f"{zero} {_ONES[int(p[1])]}")
        else:
            words.append(_two_digits(int(p)))
    return ", ".join(words)


def _ordinalize_words(words):
    """Convert cardinal words to ordinal form ('twenty-one' -> 'twenty-first')."""
    # Transform only the final word (after the last space or hyphen).
    m = re.search(r"([a-z]+)$", words)
    if not m:
        return words
    last = m.group(1)
    if last in _IRREGULAR_ORDINALS:
        repl = _IRREGULAR_ORDINALS[last]
    elif last.endswith("y"):
        repl = last[:-1] + "ieth"
    else:
        repl = last + "th"
    return words[: m.start(1)] + repl


def number_to_words(num, andword="and", zero="zero", group=0):
    """Convert a number (int or numeric string) to English words.

    Accepts ordinal-suffixed strings ("21st") and decimal strings ("3.14").
    """
    if isinstance(num, str):
        s = num.strip().replace(",", "")
        ordinal = bool(_ORDINAL_SUFFIX_RE.search(s)) and s[:-2].isdigit()
        if ordinal:
            words = number_to_words(int(s[:-2]), andword=andword,
                                    zero=zero, group=group)
            return _ordinalize_words(words)
        if "." in s:
            int_part, _, frac_part = s.partition(".")
            left = (number_to_words(int(int_part), andword=andword,
                                    zero=zero, group=group)
                    if int_part else zero)
            return f"{left} point {_digit_words(frac_part, zero)}"
        if not s.lstrip("-").isdigit():
            return s
        num = int(s)

    if group == 2:
        return _group2_words(str(num), zero=zero, andword=andword)
    words = _integer_to_words(num, andword=andword)
    if num == 0:
        words = zero
    return words

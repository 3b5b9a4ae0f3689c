"""Symbol table for text input.

Matches the reference's 185-symbol inventory (reference:text/symbols.py:9-20):
101 characters (punctuation, math, special, accented, digits, letters) plus
84 ARPAbet phonemes prefixed with '@' to keep them distinct from uppercase
letters.
"""

from .cmudict import VALID_SYMBOLS

PUNCTUATION = "!'\",.:;? "
MATH = "#%&*+-/[]()"
SPECIAL = "_@©°½—₩€$"
ACCENTED = "áçéêëñöøćž"
DIGITS = "0123456789"
LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"

ARPABET = ["@" + s for s in VALID_SYMBOLS]

symbols = list(PUNCTUATION + MATH + SPECIAL + ACCENTED + DIGITS + LETTERS) + ARPABET

assert len(symbols) == 185, f"symbol table must have 185 entries, got {len(symbols)}"

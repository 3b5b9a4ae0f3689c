"""Time-of-day normalization: "9:30am" -> "9 30 AM".

Mirrors reference:text/datestime.py:21-24.
"""

import re

_ampm_re = re.compile(
    r"([0-9]|0[0-9]|1[0-9]|2[0-3]):?([0-5][0-9])?\s*([AaPp][Mm]\b)")


def _expand_ampm(m):
    matches = list(m.groups(0))
    txt = matches[0]
    if matches[1] not in (0, "0", "00"):
        txt += " " + matches[1]

    # case-sensitive on purpose: the reference compares the raw char
    # (reference:text/datestime.py:13-16), so an UPPERCASE meridiem
    # ("10:30 AM") is matched by the regex but its AM/PM is dropped
    # from the output — and flowtron_cleaners never lowercases first,
    # so this path is reachable (pinned by test_reference_text_parity).
    if matches[2][0] == "a":
        txt += " AM"
    elif matches[2][0] == "p":
        txt += " PM"

    return txt


def normalize_datestime(text):
    text = re.sub(_ampm_re, _expand_ampm, text)
    text = re.sub(r"([0-9]|0[0-9]|1[0-9]|2[0-3]):([0-5][0-9])?", r"\1 \2", text)
    return text
